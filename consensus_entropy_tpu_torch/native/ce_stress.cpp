// Concurrency stress driver for the port's host core (ce_host.cpp,
// ce_gbdt.cpp, ce_sgd.cpp, ce_tree.cpp, ce_svm.cpp), run by
// consensus_entropy_tpu_torch/cli/race_check.py.  Counterpart of the JAX
// package's native/ce_stress.cpp: it calls every exported function of the
// core on shared inputs.
//
// Two modes (GCC's libgomp is not TSAN-instrumented, so its barriers are
// invisible to TSAN and every post-region read would be a false positive;
// each mode checks what it can soundly):
//
//   tsan         OMP team of 1 (ce_gbdt_set_threads(1) in each caller);
//                four pthreads call every function CONCURRENTLY on shared
//                read-only inputs and private outputs.  TSAN then reports
//                any hidden shared mutable state across calls (static
//                buffers, unprotected globals): the reentrancy the fleet's
//                host workers rely on (native.py, limit_threads).  The four
//                callers' outputs must be bytewise equal.
//   determinism  oversubscribed OpenMP (threads > cores): every function
//                runs twice and its outputs must be BYTEWISE equal; a data
//                race in a parallel region (overlapping writes,
//                order-dependent accumulation) shows as nondeterminism.
//                One FNV-1a digest per output is printed, so the driver
//                can hold them equal across team sizes too (native.py: the
//                team size changes no result).
//
//   ce_stress MODE [N F TREE_N SVC_N]
//
// N rows of F features feed the host members' predictions (linear softmax
// and OvA, GaussianNB), the segment mean of the GaussianNB posteriors over
// seeded segments (some empty) and their row entropies; the GBDT build and
// predict, both SGD loops and the multinomial gradient; the first TREE_N
// of them the two CART modes
// (Gini forest with bootstrap weights, sqrt(F) features drawn a node,
// trees in parallel; squared error with every feature drawn at each node,
// as gbc draws them, and scanned in parallel; every column of these rows
// ties); the first SVC_N the
// C-SVC.  Exit 0 = clean; TSAN reports flip the exit code via
// halt_on_error.

#include <algorithm>
#include <chrono>
#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>

extern "C" {
void ce_linear_predict_proba(const float*, int64_t, int64_t, const float*,
                             const float*, int64_t, int, float*);
void ce_gnb_predict_proba(const float*, int64_t, int64_t, const double*,
                          const double*, const double*, int64_t, float*);
void ce_segment_mean(const float*, int64_t, int64_t, const int64_t*, int64_t,
                     float*);
void ce_row_entropy(const float*, int64_t, int64_t, float*);
void ce_gbdt_build_tree(const uint8_t*, int64_t, int64_t, const float*,
                        const float*, int, int, double, double, double,
                        int32_t*, int32_t*, double*);
void ce_gbdt_predict_margins(const uint8_t*, int64_t, int64_t, const int32_t*,
                             const int32_t*, const double*, int64_t, int64_t,
                             const int32_t*, int64_t, double, double*);
void ce_gbdt_set_threads(int);
int ce_sgd_plain_f32(float*, double*, const float*, const float*, int64_t,
                     int64_t, uint32_t, int, double, double, double, int, int,
                     double, int32_t*, int*);
int ce_sgd_plain_f64(double*, double*, const double*, const double*, int64_t,
                     int64_t, uint32_t, int, double, double, double, int, int,
                     double, int32_t*, int*);
void* ce_trees_build(const float*, int64_t, int64_t, const double*, int64_t,
                     const double*, int64_t, int64_t, int, int, int64_t,
                     int64_t, const uint32_t*, int);
void ce_trees_sizes(void*, int64_t*);
void ce_trees_copy(void*, int64_t*, int64_t*, int64_t*, double*, uint8_t*,
                   double*);
void ce_trees_free(void*);
void ce_multinomial_neg_gradient(const double*, const double*, int64_t,
                                 int64_t, double*);
void* ce_svc_train(const double*, int64_t, int64_t, const double*, double,
                   double, double, int, double, int64_t);
void ce_svc_sizes(void*, int64_t*);
void ce_svc_copy(void*, int64_t*, int64_t*, double*, double*, double*,
                 double*, int64_t*);
void ce_svc_free(void*);
}

namespace {

constexpr int64_t C = 4, N_BINS = 32, GBDT_TREES = 8, FOREST_TREES = 4,
                  MSE_TREES = 4;
constexpr int GBDT_DEPTH = 5, FOREST_DEPTH = 10, MSE_DEPTH = 3;
constexpr int64_t GBDT_NODES = ((int64_t)1 << (GBDT_DEPTH + 1)) - 1;
constexpr int SGD_EPOCHS = 3;

struct Sizes {
  int64_t n, f, tree_n, svc_n;
};

struct Rng {  // xorshift64: the inputs depend on nothing but the sizes
  uint64_t s = 88172645463325252ull;
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  double unit() { return (double)(next() % 10000) / 5000.0 - 1.0; }
};

struct Inputs {
  Sizes z;
  std::vector<float> X32, g, h, y01_32;
  std::vector<double> X64, y01_64, label, raw, resid, boot;
  std::vector<uint8_t> Xb;
  std::vector<int32_t> tree_class;
  std::vector<uint32_t> seeds;
  double gamma;
  // the host members: a linear model (f, C), GaussianNB's parameters
  // (C, f) and log priors, and the segments' n_segs + 1 offsets
  std::vector<float> W, b;
  std::vector<double> theta, var, log_prior;
  std::vector<int64_t> starts;

  explicit Inputs(Sizes sizes) : z(sizes) {
    Rng r;
    const int64_t n = z.n, f = z.f;
    std::vector<double> centers(C * f);
    for (auto& v : centers) v = 0.25 * r.unit();  // classes overlap
    label.resize(n);
    X32.resize(n * f);
    X64.resize(n * f);
    Xb.resize(n * f);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t c = (int64_t)(r.next() % C);
      label[i] = (double)c;
      for (int64_t j = 0; j < f; ++j) {
        // multiples of 1/64: float32 and float64 hold the same value
        const double v =
            std::round((centers[c * f + j] + r.unit()) * 64.0) / 64.0;
        X32[i * f + j] = (float)v;
        X64[i * f + j] = v;
        Xb[i * f + j] = (uint8_t)(r.next() % N_BINS);
      }
    }
    g.resize(n);
    h.resize(n);
    y01_32.resize(n);
    y01_64.resize(n);
    raw.resize(n * C);
    for (int64_t i = 0; i < n; ++i) {
      g[i] = (float)r.unit();
      h[i] = (float)(r.unit() * r.unit() + 0.1);
      y01_32[i] = label[i] == 0.0 ? 1.0f : 0.0f;
      y01_64[i] = y01_32[i];
    }
    for (auto& v : raw) v = 3.0 * r.unit();
    // the squared-error trees fit each class's residual, the Gini forest
    // bootstrap counts a tree
    resid.resize(MSE_TREES * z.tree_n);
    for (auto& v : resid) v = r.unit();
    boot.assign(FOREST_TREES * z.tree_n, 0.0);
    for (int64_t t = 0; t < FOREST_TREES; ++t)
      for (int64_t i = 0; i < z.tree_n; ++i)
        boot[t * z.tree_n + r.next() % z.tree_n] += 1.0;
    for (int64_t t = 0; t < FOREST_TREES + MSE_TREES; ++t)
      seeds.push_back((uint32_t)(r.next() % 0x7FFFFFFFu));
    for (int64_t t = 0; t < GBDT_TREES; ++t)
      tree_class.push_back((int32_t)(t % C));
    // SVC(gamma="scale"): 1 / (f * X.var()) over the SVC rows
    double mean = 0.0, sq = 0.0;
    const int64_t m = z.svc_n * f;
    for (int64_t i = 0; i < m; ++i) mean += X64[i];
    mean /= (double)m;
    for (int64_t i = 0; i < m; ++i) sq += (X64[i] - mean) * (X64[i] - mean);
    gamma = 1.0 / ((double)f * sq / (double)m);
    W.resize(f * C);
    for (auto& v : W) v = (float)(0.3 * r.unit());
    for (int64_t k = 0; k < C; ++k) {
      b.push_back((float)r.unit());
      log_prior.push_back(std::log(1.0 / (double)C));
    }
    theta.assign(centers.begin(), centers.end());
    var.resize(C * f);
    for (auto& v : var) v = 0.5 + std::fabs(r.unit());
    // segments of 0 to 15 rows
    starts.push_back(0);
    while (starts.back() < n)
      starts.push_back(std::min<int64_t>(n, starts.back() + r.next() % 16));
  }
};

// One named output: its bytes, compared between runs and callers; and
// each group of calls' wall seconds.
struct Outputs {
  std::vector<std::pair<std::string, std::vector<uint8_t>>> items;
  std::vector<std::pair<std::string, double>> walls;
  std::chrono::steady_clock::time_point t0 = std::chrono::steady_clock::now();

  void lap(const std::string& group) {
    const auto now = std::chrono::steady_clock::now();
    walls.emplace_back(group,
                       std::chrono::duration<double>(now - t0).count());
    t0 = now;
  }

  template <typename T>
  void add(const std::string& name, const T* p, size_t count) {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
    items.emplace_back(name, std::vector<uint8_t>(b, b + count * sizeof(T)));
  }
  template <typename T>
  void add(const std::string& name, const std::vector<T>& v) {
    add(name, v.data(), v.size());
  }
};

void run_trees(const Inputs& in, bool gini, Outputs& out) {
  const int64_t n = in.z.tree_n, f = in.z.f;
  const int64_t n_trees = gini ? FOREST_TREES : MSE_TREES;
  const int64_t max_features =
      gini ? std::max<int64_t>(1, (int64_t)std::sqrt((double)f)) : f;
  std::vector<double> ones(n, 1.0);
  void* handle = ce_trees_build(
      in.X32.data(), n, f, gini ? in.label.data() : in.resid.data(),
      gini ? 0 : n, gini ? in.boot.data() : ones.data(), gini ? n : 0,
      n_trees, gini ? 0 : 1, gini ? (int)C : 1, max_features,
      gini ? FOREST_DEPTH : MSE_DEPTH,
      in.seeds.data() + (gini ? 0 : FOREST_TREES), gini ? 0 : 1);
  std::vector<int64_t> counts(n_trees);
  ce_trees_sizes(handle, counts.data());
  int64_t m = 0;
  for (int64_t c : counts) m += c;
  const int64_t vs = gini ? C : 1;
  std::vector<int64_t> left(m), right(m), feature(m);
  std::vector<double> threshold(m), value(m * vs);
  std::vector<uint8_t> missing_left(m);
  ce_trees_copy(handle, left.data(), right.data(), feature.data(),
                threshold.data(), missing_left.data(), value.data());
  ce_trees_free(handle);
  const std::string p = gini ? "forest." : "mse_scan.";
  out.add(p + "counts", counts);
  out.add(p + "left", left);
  out.add(p + "right", right);
  out.add(p + "feature", feature);
  out.add(p + "threshold", threshold);
  out.add(p + "missing_left", missing_left);
  out.add(p + "value", value);
}

void run_svc(const Inputs& in, Outputs& out) {
  void* handle = ce_svc_train(in.X64.data(), in.z.svc_n, in.z.f,
                              in.label.data(), 1.0, in.gamma, 1e-3, 1, 200.0,
                              1987);
  int64_t sizes[3];
  ce_svc_sizes(handle, sizes);
  const int64_t k = sizes[0], l = sizes[1], pairs = k * (k - 1) / 2;
  std::vector<int64_t> support(l), n_support(k), n_iter(pairs);
  std::vector<double> dual((k - 1) * l), icpt(pairs), pa(pairs), pb(pairs);
  ce_svc_copy(handle, support.data(), n_support.data(), dual.data(),
              icpt.data(), pa.data(), pb.data(), n_iter.data());
  ce_svc_free(handle);
  out.add("svc.sizes", sizes, 3);
  out.add("svc.support", support);
  out.add("svc.n_support", n_support);
  out.add("svc.dual_coef", dual);
  out.add("svc.intercept", icpt);
  out.add("svc.prob_a", pa);
  out.add("svc.prob_b", pb);
  out.add("svc.n_iter", n_iter);
}

template <typename T, typename Fn>
void run_sgd(const std::vector<T>& X, const std::vector<T>& y, int64_t n,
             int64_t f, Fn fn, const std::string& name, Outputs& out) {
  std::vector<T> w(f, T(0));
  std::vector<int32_t> index(n);
  double icpt = 0.0;
  int epochs = 0;
  const int status = fn(w.data(), &icpt, X.data(), y.data(), n, f, 1987u,
                        SGD_EPOCHS, 1.0, 1e-4, 1e-3, 5, 1, 0.0, index.data(),
                        &epochs);
  const int64_t tail[2] = {status, epochs};
  out.add(name + ".w", w);
  out.add(name + ".intercept", &icpt, 1);
  out.add(name + ".status_epochs", tail, 2);
}

void run_host(const Inputs& in, Outputs& out) {
  const int64_t n = in.z.n, f = in.z.f;
  const int64_t n_segs = (int64_t)in.starts.size() - 1;
  std::vector<float> soft(n * C), ova(n * C), gnb(n * C), means(n_segs * C),
      ent(n);
  ce_linear_predict_proba(in.X32.data(), n, f, in.W.data(), in.b.data(), C,
                          0, soft.data());
  ce_linear_predict_proba(in.X32.data(), n, f, in.W.data(), in.b.data(), C,
                          1, ova.data());
  ce_gnb_predict_proba(in.X32.data(), n, f, in.theta.data(), in.var.data(),
                       in.log_prior.data(), C, gnb.data());
  ce_segment_mean(gnb.data(), n, C, in.starts.data(), n_segs, means.data());
  ce_row_entropy(gnb.data(), n, C, ent.data());
  out.add("host.linear_softmax", soft);
  out.add("host.linear_ova", ova);
  out.add("host.gnb", gnb);
  out.add("host.segment_mean", means);
  out.add("host.row_entropy", ent);
}

Outputs run_all(const Inputs& in) {
  Outputs out;
  const int64_t n = in.z.n, f = in.z.f;
  run_host(in, out);
  out.lap("host");
  std::vector<int32_t> feat(GBDT_TREES * GBDT_NODES),
      thr(GBDT_TREES * GBDT_NODES);
  std::vector<double> val(GBDT_TREES * GBDT_NODES);
  for (int64_t t = 0; t < GBDT_TREES; ++t) {
    // each tree fits its own rotation of the gradients
    std::vector<float> g(in.g.begin() + t, in.g.end());
    g.insert(g.end(), in.g.begin(), in.g.begin() + t);
    ce_gbdt_build_tree(in.Xb.data(), n, f, g.data(), in.h.data(), GBDT_DEPTH,
                       (int)N_BINS, 1.0, 1.0, 0.0, feat.data() + t * GBDT_NODES,
                       thr.data() + t * GBDT_NODES,
                       val.data() + t * GBDT_NODES);
  }
  std::vector<double> margins(n * C, 0.0);
  ce_gbdt_predict_margins(in.Xb.data(), n, f, feat.data(), thr.data(),
                          val.data(), GBDT_TREES, GBDT_NODES,
                          in.tree_class.data(), C, 0.3, margins.data());
  out.add("gbdt.feature", feat);
  out.add("gbdt.threshold", thr);
  out.add("gbdt.value", val);
  out.add("gbdt.margins", margins);
  out.lap("gbdt");
  run_sgd(in.X32, in.y01_32, n, f, ce_sgd_plain_f32, "sgd_f32", out);
  run_sgd(in.X64, in.y01_64, n, f, ce_sgd_plain_f64, "sgd_f64", out);
  out.lap("sgd");
  run_trees(in, true, out);
  out.lap("forest");
  run_trees(in, false, out);
  out.lap("mse_scan");
  std::vector<double> grad(n * C);
  ce_multinomial_neg_gradient(in.raw.data(), in.label.data(), n, C,
                              grad.data());
  out.add("multinomial", grad);
  out.lap("multinomial");
  run_svc(in, out);
  out.lap("svc");
  return out;
}

uint64_t fnv1a(const std::vector<uint8_t>& b) {
  uint64_t hsh = 1469598103934665603ull;
  for (uint8_t c : b) {
    hsh ^= c;
    hsh *= 1099511628211ull;
  }
  return hsh;
}

// The first output whose bytes differ, or nullptr.
const std::string* first_difference(const Outputs& a, const Outputs& b) {
  for (size_t i = 0; i < a.items.size(); ++i)
    if (a.items[i].second != b.items[i].second) return &a.items[i].first;
  return nullptr;
}

int64_t arg(int argc, char** argv, int i, int64_t fallback) {
  return argc > i ? std::strtoll(argv[i], nullptr, 10) : fallback;
}

}  // namespace

int main(int argc, char** argv) {
  const std::string mode = argc > 1 ? argv[1] : "determinism";
  Sizes z{arg(argc, argv, 2, 2048), arg(argc, argv, 3, 32), 0, 0};
  z.tree_n = std::min(z.n, arg(argc, argv, 4, 1024));
  z.svc_n = std::min(z.n, arg(argc, argv, 5, 200));
  if (z.n < 64 || z.f < 2 || z.tree_n < 8 || z.svc_n < 8 ||
      (mode != "tsan" && mode != "determinism")) {
    std::fprintf(stderr,
                 "usage: ce_stress tsan|determinism [N>=64 F>=2 TREE_N>=8 "
                 "SVC_N>=8]\n");
    return 2;
  }
  const Inputs in(z);

  if (mode == "tsan") {
    // concurrent calls: shared inputs, private outputs
    std::vector<Outputs> outs(4);
    std::vector<std::thread> threads;
    for (int t = 0; t < 4; ++t)
      threads.emplace_back([&in, &outs, t] {
        // the OpenMP team of THIS caller (an ICV of the calling thread):
        // in-region parallelism under TSAN would be libgomp noise
        ce_gbdt_set_threads(1);
        outs[t] = run_all(in);
      });
    for (auto& th : threads) th.join();
    for (int t = 1; t < 4; ++t)
      if (const std::string* name = first_difference(outs[0], outs[t])) {
        std::fprintf(stderr, "caller %d's %s differs from caller 0's\n", t,
                     name->c_str());
        return 1;
      }
    std::printf("tsan stress ok: 4 callers, %zu outputs equal\n",
                outs[0].items.size());
    return 0;
  }

  // determinism: bytewise-equal repeat runs at this team size
  const Outputs a = run_all(in), b = run_all(in);
  if (const std::string* name = first_difference(a, b)) {
    std::fprintf(stderr, "nondeterministic %s across repeat runs\n",
                 name->c_str());
    return 1;
  }
  for (const auto& item : a.items)
    std::printf("digest %s %016" PRIx64 " %zu\n", item.first.c_str(),
                fnv1a(item.second), item.second.size());
  for (const auto& w : a.walls)
    std::printf("wall %s %.3f\n", w.first.c_str(), w.second);
  std::printf("determinism ok\n");
  return 0;
}
