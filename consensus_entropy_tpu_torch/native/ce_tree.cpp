// Dense best-split CART host core of consensus_entropy_tpu_torch: the tree
// builder behind the random forest (rf), the gradient-boosting classifier
// (gbc) and the boosted slot's scikit-learn member, after scikit-learn
// 1.9.0's sklearn/tree:
//
//   _tree.pyx        DepthFirstTreeBuilder.build (depth-first, left child
//                    popped first, node ids in creation order)
//   _splitter.pyx    BestSplitter / node_split_best: Fisher-Yates feature
//                    draw from our_rand_r, constant-feature tracking
//                    (FEATURE_THRESHOLD), midpoint thresholds
//   _partitioner.pyx DensePartitioner: sort, next_p, partition_samples_final
//   _criterion.pyx   Gini (classification) and MSE (squared_error; the
//                    deprecated friedman_mse maps to it in 1.9)
//   utils/_sorting.pyx simultaneous_sort (introsort, 3-way partition)
//   utils/_random.pxd  our_rand_r
//
// Every floating-point operation is the one scikit-learn's Cython does, in
// its order, so a tree is the same bits; models/tree_fit.py::_plain_tree is
// the plain version.  Rows hold no NaN (the Python side checks), so the
// missing-value branches are left out.
//
// ce_trees_build builds n_trees independent trees in an OpenMP loop over
// trees (a tree depends only on its own inputs and seed), or the trees in
// turn with each node's drawn features scanned in an OpenMP loop and
// reduced in draw order (parallel_scan); either way a tree is the same
// bits whatever the team size.  The trees live in a handle until
// ce_trees_copy has read them out and ce_trees_free released them.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr float FEATURE_THRESHOLD = 1e-7f;  // _partitioner.pxd
constexpr double EPSILON = DBL_EPSILON;      // _tree.pyx
constexpr uint32_t RAND_R_MAX = 0x7FFFFFFFu;
constexpr int64_t TREE_LEAF = -1;
constexpr int64_t TREE_UNDEFINED = -2;

inline uint32_t our_rand_r(uint32_t* seed) {
  if (*seed == 0) *seed = 1;
  *seed ^= (uint32_t)(*seed << 13);
  *seed ^= (uint32_t)(*seed >> 17);
  *seed ^= (uint32_t)(*seed << 5);
  return *seed % (RAND_R_MAX + 1u);
}

inline int64_t rand_int(int64_t low, int64_t high, uint32_t* seed) {
  return low + (int64_t)our_rand_r(seed) % (high - low);
}

// ---- utils/_sorting.pyx: simultaneous_sort(use_three_way_partition=True)

inline void swap_vi(float* v, int64_t* idx, int64_t i, int64_t j) {
  float t = v[i]; v[i] = v[j]; v[j] = t;
  int64_t u = idx[i]; idx[i] = idx[j]; idx[j] = u;
}

inline float median3(const float* v, int64_t n) {
  float a = v[0], b = v[n / 2], c = v[n - 1];
  if (a < b) {
    if (b < c) return b;
    if (a < c) return c;
    return a;
  }
  if (b < c) {
    if (a < c) return a;
    return c;
  }
  return b;
}

void insertion_sort(float* v, int64_t* idx, int64_t n) {
  for (int64_t i = 1; i < n; ++i) {
    float tv = v[i];
    int64_t ti = idx[i];
    int64_t j = i;
    while (j > 0 && v[j - 1] > tv) {
      v[j] = v[j - 1];
      idx[j] = idx[j - 1];
      --j;
    }
    v[j] = tv;
    idx[j] = ti;
  }
}

void sift_down(float* v, int64_t* idx, int64_t start, int64_t end) {
  int64_t root = start;
  while (true) {
    int64_t child = root * 2 + 1;
    int64_t maxind = root;
    if (child < end && v[maxind] < v[child]) maxind = child;
    if (child + 1 < end && v[maxind] < v[child + 1]) maxind = child + 1;
    if (maxind == root) break;
    swap_vi(v, idx, root, maxind);
    root = maxind;
  }
}

void heapsort(float* v, int64_t* idx, int64_t n) {
  int64_t start = (n - 2) / 2, end = n;
  while (true) {
    sift_down(v, idx, start, end);
    if (start == 0) break;
    --start;
  }
  end = n - 1;
  while (end > 0) {
    swap_vi(v, idx, 0, end);
    sift_down(v, idx, 0, end);
    --end;
  }
}

void introsort_3way(float* v, int64_t* idx, int64_t n, int64_t maxd) {
  while (n > 15) {
    if (maxd <= 0) {
      heapsort(v, idx, n);
      return;
    }
    --maxd;
    float pivot = median3(v, n);
    int64_t i = 0, l = 0, r = n;
    while (i < r) {
      if (v[i] < pivot) {
        swap_vi(v, idx, i, l);
        ++i;
        ++l;
      } else if (v[i] > pivot) {
        --r;
        swap_vi(v, idx, i, r);
      } else {
        ++i;
      }
    }
    introsort_3way(v, idx, l, maxd);
    v += r;
    idx += r;
    n -= r;
  }
  insertion_sort(v, idx, n);
}

void simultaneous_sort(float* v, int64_t* idx, int64_t n) {
  if (n == 0) return;
  int64_t maxd = 2 * (int64_t)std::log2((double)n);
  introsort_3way(v, idx, n, maxd);
}

// ---- _criterion.pyx: Gini and MSE over samples[start:end]

struct Criterion {
  bool gini;
  int n_classes;
  const double* y;
  const double* sw;
  const int64_t* samples;
  int64_t start = 0, pos = 0, end = 0;
  double weighted_n_samples = 0, weighted_n_node_samples = 0;
  double weighted_n_left = 0, weighted_n_right = 0;
  // gini: per class; mse: element 0 only
  std::vector<double> sum_total, sum_left, sum_right;
  double sq_sum_total = 0;

  Criterion(bool gini_, int n_classes_, const double* y_, const double* sw_,
            const int64_t* samples_, double wns)
      : gini(gini_), n_classes(gini_ ? n_classes_ : 1), y(y_), sw(sw_),
        samples(samples_), weighted_n_samples(wns),
        sum_total(n_classes), sum_left(n_classes), sum_right(n_classes) {}

  void init(int64_t s, int64_t e) {
    start = s;
    end = e;
    weighted_n_node_samples = 0.0;
    std::fill(sum_total.begin(), sum_total.end(), 0.0);
    sq_sum_total = 0.0;
    for (int64_t p = s; p < e; ++p) {
      int64_t i = samples[p];
      double w = sw[i];
      if (gini) {
        sum_total[(int64_t)y[i]] += w;
      } else {
        double y_ik = y[i];
        double w_y_ik = w * y_ik;
        sum_total[0] += w_y_ik;
        sq_sum_total += w_y_ik * y_ik;
      }
      weighted_n_node_samples += w;
    }
    reset();
  }

  void reset() {
    pos = start;
    std::fill(sum_left.begin(), sum_left.end(), 0.0);
    sum_right = sum_total;
    weighted_n_left = 0.0;
    weighted_n_right = weighted_n_node_samples;
  }

  void reverse_reset() {
    pos = end;
    std::fill(sum_right.begin(), sum_right.end(), 0.0);
    sum_left = sum_total;
    weighted_n_right = 0.0;
    weighted_n_left = weighted_n_node_samples;
  }

  void update(int64_t new_pos) {
    if ((new_pos - pos) <= (end - new_pos)) {
      for (int64_t p = pos; p < new_pos; ++p) {
        int64_t i = samples[p];
        double w = sw[i];
        if (gini) sum_left[(int64_t)y[i]] += w;
        else sum_left[0] += w * y[i];
        weighted_n_left += w;
      }
    } else {
      reverse_reset();
      for (int64_t p = end - 1; p > new_pos - 1; --p) {
        int64_t i = samples[p];
        double w = sw[i];
        if (gini) sum_left[(int64_t)y[i]] -= w;
        else sum_left[0] -= w * y[i];
        weighted_n_left -= w;
      }
    }
    weighted_n_right = weighted_n_node_samples - weighted_n_left;
    for (int c = 0; c < n_classes; ++c)
      sum_right[c] = sum_total[c] - sum_left[c];
    pos = new_pos;
  }

  double node_impurity() const {
    if (gini) {
      double sq_count = 0.0;
      for (int c = 0; c < n_classes; ++c) {
        double count_k = sum_total[c];
        sq_count += count_k * count_k;
      }
      double g = 0.0;
      g += 1.0 - sq_count / (weighted_n_node_samples *
                             weighted_n_node_samples);
      return g / 1;
    }
    double impurity = sq_sum_total / weighted_n_node_samples;
    impurity -= std::pow(sum_total[0] / weighted_n_node_samples, 2.0);
    return impurity / 1;
  }

  void children_impurity(double* left, double* right) const {
    if (gini) {
      double sq_l = 0.0, sq_r = 0.0;
      for (int c = 0; c < n_classes; ++c) {
        double count_k = sum_left[c];
        sq_l += count_k * count_k;
        count_k = sum_right[c];
        sq_r += count_k * count_k;
      }
      double gl = 0.0, gr = 0.0;
      gl += 1.0 - sq_l / (weighted_n_left * weighted_n_left);
      gr += 1.0 - sq_r / (weighted_n_right * weighted_n_right);
      *left = gl / 1;
      *right = gr / 1;
      return;
    }
    double sq_sum_left = 0.0;
    for (int64_t p = start; p < pos; ++p) {
      int64_t i = samples[p];
      double w = sw[i];
      double y_ik = y[i];
      sq_sum_left += w * y_ik * y_ik;
    }
    double sq_sum_right = sq_sum_total - sq_sum_left;
    *left = sq_sum_left / weighted_n_left;
    *right = sq_sum_right / weighted_n_right;
    *left -= std::pow(sum_left[0] / weighted_n_left, 2.0);
    *right -= std::pow(sum_right[0] / weighted_n_right, 2.0);
    *left /= 1;
    *right /= 1;
  }

  double proxy_impurity_improvement() const {
    if (gini) {
      double il, ir;
      children_impurity(&il, &ir);
      return (-weighted_n_right * ir - weighted_n_left * il);
    }
    double pl = 0.0, pr = 0.0;
    pl += sum_left[0] * sum_left[0];
    pr += sum_right[0] * sum_right[0];
    return (pl / weighted_n_left + pr / weighted_n_right);
  }

  double impurity_improvement(double parent, double il, double ir) const {
    return ((weighted_n_node_samples / weighted_n_samples) *
            (parent - (weighted_n_right / weighted_n_node_samples * ir)
                    - (weighted_n_left / weighted_n_node_samples * il)));
  }

  void node_value(double* dest) const {
    for (int c = 0; c < n_classes; ++c)
      dest[c] = sum_total[c] / weighted_n_node_samples;
  }
};

struct SplitRecord {
  int64_t feature = 0, pos = 0;
  double threshold = 0.0, improvement = -INFINITY;
  double impurity_left = INFINITY, impurity_right = INFINITY;
  uint8_t missing_go_to_left = 0;
};

struct Tree {
  std::vector<int64_t> left, right, feature;
  std::vector<double> threshold, value;
  std::vector<uint8_t> missing_left;
  // the build's feature visits that the sequential loop sorts (drawn, not
  // known constant) and the sorts of samples by a feature it made
  int64_t visits = 0, sorts = 0;
};

struct Params {
  const float* X;
  int64_t n, f;
  bool gini;
  int n_classes;
  int64_t max_features, max_depth;
  bool parallel_features;
};

// scikit-learn's defaults, which every fit here keeps
constexpr int64_t MIN_SAMPLES_SPLIT = 2;
constexpr int64_t MIN_SAMPLES_LEAF = 1;

// nodes smaller than this scan their features in turn even when the
// features are scanned in parallel (the same split either way)
constexpr int64_t PARALLEL_MIN_SAMPLES = 256;

// The split scan of one feature over samples[start:end], sorted with
// fv: every position next_p gives, each better proxy than best_proxy
// becoming best (Criterion is reset first).
void scan_feature(const Params& P, Criterion& crit, const float* fv,
                  int64_t start, int64_t end, SplitRecord current,
                  SplitRecord& best, double& best_proxy) {
  crit.reset();
  int64_t p = start, p_prev = start;
  while (p < end) {
    // next_p (no missing values)
    ++p;
    while (p < end && fv[p] <= fv[p - 1] + FEATURE_THRESHOLD) ++p;
    p_prev = p - 1;
    if (p == end) continue;
    int64_t n_left = p - start, n_right = end - p;
    if (n_left < MIN_SAMPLES_LEAF || n_right < MIN_SAMPLES_LEAF) continue;
    current.pos = p;
    crit.update(current.pos);
    if (crit.weighted_n_left < 0.0 || crit.weighted_n_right < 0.0) continue;
    double proxy = crit.proxy_impurity_improvement();
    if (proxy > best_proxy) {
      best_proxy = proxy;
      current.threshold = fv[p_prev] / 2.0 + fv[p] / 2.0;
      current.missing_go_to_left = n_left > n_right;
      best = current;
    }
  }
}

// node_split_best's feature loop with the drawn features scanned in
// parallel, the same split and the same sample order as the sequential
// loop.  The draws come first, in their order: a drawn feature is
// constant exactly when its node maximum is within FEATURE_THRESHOLD of
// its minimum, which needs no sort.  The sequential loop sorts the
// samples by each drawn feature in turn, each sort starting from the
// order the previous one left, and the order within runs of equal values
// (which the scan's sums and the final partition see) depends on that
// start.  A sort by values without ties gives one order whatever its
// start, so every visit is first sorted from the node's order, in
// parallel; then each maximal run of visits with ties is replayed from
// the visit before it, sorting by each visit of the run in turn as the
// sequential loop does, the runs in parallel with one another (a run
// that opens the node is right from its first visit on).  A visit is sorted at most twice, so the
// cost stays linear in the features drawn however many tie.  Each scan
// keeps its own first best; taking them in draw order with the loop's
// strict comparison gives the loop's best.  samples[start:end] is left
// as the last visit's sort leaves it.
struct Visit {
  int64_t feature;
  bool constant;
};

int64_t parallel_scan(const Params& P, const Criterion& crit,
                      std::vector<int64_t>& samples, int64_t start,
                      int64_t end, const std::vector<Visit>& visits,
                      SplitRecord& best) {
  const int64_t F = P.f, m = (int64_t)visits.size(), len = end - start;
  // each visit's samples sorted from the node's order, its sorted values,
  // and whether any tie: without ties, the sequential loop's order after
  // that visit
  std::vector<int64_t> orders(m * len);
  std::vector<float> values(m * len);
  std::vector<char> ties(m, 0);
  int64_t replays = 0;
#pragma omp parallel for schedule(dynamic, 4)
  for (int64_t k = 0; k < m; ++k) {
    const int64_t feat = visits[k].feature;
    int64_t* order = &orders[k * len];
    float* fv = &values[k * len];
    std::copy(samples.begin() + start, samples.begin() + end, order);
    for (int64_t p = 0; p < len; ++p) fv[p] = P.X[order[p] * F + feat];
    simultaneous_sort(fv, order, len);
    for (int64_t p = 1; p < len && !ties[k]; ++p)
      if (fv[p] == fv[p - 1]) ties[k] = 1;
  }
  // the runs of visits with ties, [first, last)
  std::vector<std::pair<int64_t, int64_t>> runs;
  for (int64_t k = 0; k < m; ++k)
    if (ties[k]) {
      if (runs.empty() || runs.back().second != k) runs.push_back({k, k});
      runs.back().second = k + 1;
    }
  const int64_t n_runs = (int64_t)runs.size();
#pragma omp parallel for schedule(dynamic, 1) reduction(+ : replays)
  for (int64_t r = 0; r < n_runs; ++r) {
    // visit 0 was sorted from the node's order already
    for (int64_t u = std::max<int64_t>(runs[r].first, 1);
         u < runs[r].second; ++u) {
      ++replays;
      int64_t* order = &orders[u * len];
      float* fv = &values[u * len];
      std::copy(order - len, order, order);
      const int64_t feat = visits[u].feature;
      for (int64_t p = 0; p < len; ++p) fv[p] = P.X[order[p] * F + feat];
      simultaneous_sort(fv, order, len);
    }
  }
  std::vector<SplitRecord> bests(m);
  std::vector<double> proxies(m, -INFINITY);
#pragma omp parallel
  {
    std::vector<int64_t> order(P.n);
    std::vector<float> fv(P.n);
    Criterion local = crit;
    local.samples = order.data();
#pragma omp for schedule(dynamic, 1)
    for (int64_t k = 0; k < m; ++k) {
      if (visits[k].constant) continue;
      std::copy(orders.begin() + k * len, orders.begin() + (k + 1) * len,
                order.begin() + start);
      std::copy(values.begin() + k * len, values.begin() + (k + 1) * len,
                fv.begin() + start);
      SplitRecord current, found;
      double found_proxy = -INFINITY;
      current.feature = visits[k].feature;
      scan_feature(P, local, fv.data(), start, end, current, found,
                   found_proxy);
      // a thread's own best, stored once: neighbouring entries share
      // cache lines
      bests[k] = found;
      proxies[k] = found_proxy;
    }
  }
  double best_proxy = -INFINITY;
  for (int64_t k = 0; k < m; ++k)
    if (!visits[k].constant && proxies[k] > best_proxy) {
      best_proxy = proxies[k];
      best = bests[k];
    }
  if (m) std::copy(orders.begin() + (m - 1) * len, orders.end(),
                   samples.begin() + start);
  return m + replays;
}

// DepthFirstTreeBuilder.build with BestSplitter and DensePartitioner
void build_tree(const Params& P, const double* y, const double* sw,
                uint32_t rand_r_state, Tree& T) {
  const int64_t F = P.f;
  // Splitter.init: rows of weight 0 are left out
  std::vector<int64_t> samples;
  samples.reserve(P.n);
  double weighted_n_samples = 0.0;
  for (int64_t i = 0; i < P.n; ++i) {
    if (sw[i] != 0.0) samples.push_back(i);
    weighted_n_samples += sw[i];
  }
  std::vector<int64_t> features(F), constant_features(F);
  for (int64_t j = 0; j < F; ++j) features[j] = j;
  std::vector<float> fv(P.n);
  Criterion crit(P.gini, P.n_classes, y, sw, samples.data(),
                 weighted_n_samples);
  const int vs = crit.n_classes;

  struct Rec {
    int64_t start, end, depth, parent;
    bool is_left;
    double impurity;
    int64_t n_constant_features;
  };
  std::vector<Rec> stack;
  stack.push_back({0, (int64_t)samples.size(), 0, TREE_UNDEFINED, false,
                   INFINITY, 0});
  bool first = true;
  std::vector<double> value(vs);
  SplitRecord split;

  while (!stack.empty()) {
    Rec r = stack.back();
    stack.pop_back();
    const int64_t start = r.start, end = r.end, depth = r.depth;
    double parent_impurity = r.impurity;
    int64_t n_constant = r.n_constant_features;
    const int64_t n_node_samples = end - start;
    crit.init(start, end);
    const double weighted_n_node = crit.weighted_n_node_samples;
    bool is_leaf = (depth >= P.max_depth ||
                    n_node_samples < MIN_SAMPLES_SPLIT ||
                    n_node_samples < 2 * MIN_SAMPLES_LEAF ||
                    weighted_n_node < 2 * 0.0);
    if (first) {
      parent_impurity = crit.node_impurity();
      first = false;
    }
    is_leaf = is_leaf || parent_impurity <= EPSILON;

    if (!is_leaf) {
      // node_split_best
      SplitRecord best, current;
      best.pos = end;
      double best_proxy = -INFINITY;
      int64_t f_i = F, n_visited = 0, n_found_constants = 0,
              n_drawn_constants = 0, n_known_constants = n_constant,
              n_total_constants = n_known_constants;
      const bool in_parallel = P.parallel_features &&
                               n_node_samples >= PARALLEL_MIN_SAMPLES;
      std::vector<Visit> visits;
      std::vector<char> is_constant;
      if (in_parallel) {
        // every feature that may be drawn: constant exactly when its node
        // maximum is within FEATURE_THRESHOLD of its minimum (the sorted
        // ends the sequential loop compares), which needs no sort
        is_constant.assign(F, 0);
#pragma omp parallel for schedule(dynamic, 8)
        for (int64_t j = n_known_constants; j < F; ++j) {
          const int64_t feat = features[j];
          float lo = P.X[samples[start] * F + feat], hi = lo;
          for (int64_t p = start + 1; p < end; ++p) {
            float v = P.X[samples[p] * F + feat];
            if (v < lo) lo = v;
            if (v > hi) hi = v;
          }
          is_constant[feat] = hi <= lo + FEATURE_THRESHOLD;
        }
      }
      while (f_i > n_total_constants &&
             (n_visited < P.max_features ||
              n_visited <= n_found_constants + n_drawn_constants)) {
        ++n_visited;
        int64_t f_j = rand_int(n_drawn_constants, f_i - n_found_constants,
                               &rand_r_state);
        if (f_j < n_known_constants) {
          std::swap(features[n_drawn_constants], features[f_j]);
          ++n_drawn_constants;
          continue;
        }
        f_j += n_found_constants;
        current.feature = features[f_j];
        const int64_t feat = current.feature;
        ++T.visits;
        bool constant;
        if (in_parallel) {
          constant = is_constant[feat];
          visits.push_back({feat, constant});
        } else {
          for (int64_t p = start; p < end; ++p)
            fv[p] = P.X[samples[p] * F + feat];
          simultaneous_sort(&fv[start], &samples[start], end - start);
          ++T.sorts;
          constant = fv[end - 1] <= fv[start] + FEATURE_THRESHOLD;
        }
        if (constant) {
          std::swap(features[f_j], features[n_total_constants]);
          ++n_found_constants;
          ++n_total_constants;
          continue;
        }
        --f_i;
        std::swap(features[f_i], features[f_j]);
        if (!in_parallel)
          scan_feature(P, crit, fv.data(), start, end, current, best,
                       best_proxy);
      }
      if (in_parallel)
        T.sorts += parallel_scan(P, crit, samples, start, end, visits, best);
      if (best.pos < end) {
        // partition_samples_final
        int64_t ps = start, pe = end;
        while (ps < pe) {
          float cv = P.X[samples[ps] * F + best.feature];
          if (cv <= best.threshold) {
            ++ps;
          } else {
            --pe;
            std::swap(samples[ps], samples[pe]);
          }
        }
        crit.reset();
        crit.update(best.pos);
        crit.children_impurity(&best.impurity_left, &best.impurity_right);
        best.improvement = crit.impurity_improvement(
            parent_impurity, best.impurity_left, best.impurity_right);
      }
      std::memcpy(features.data(), constant_features.data(),
                  sizeof(int64_t) * n_known_constants);
      std::memcpy(constant_features.data() + n_known_constants,
                  features.data() + n_known_constants,
                  sizeof(int64_t) * n_found_constants);
      n_constant = n_total_constants;
      split = best;
      is_leaf = is_leaf || split.pos >= end ||
                split.improvement + EPSILON < 0.0;
    }

    // Tree._add_node
    const int64_t node_id = (int64_t)T.left.size();
    if (r.parent != TREE_UNDEFINED) {
      if (r.is_left) T.left[r.parent] = node_id;
      else T.right[r.parent] = node_id;
    }
    if (is_leaf) {
      T.left.push_back(TREE_LEAF);
      T.right.push_back(TREE_LEAF);
      T.feature.push_back(TREE_UNDEFINED);
      T.threshold.push_back((double)TREE_UNDEFINED);
      T.missing_left.push_back(0);
    } else {
      T.left.push_back(TREE_LEAF);
      T.right.push_back(TREE_LEAF);
      T.feature.push_back(split.feature);
      T.threshold.push_back(split.threshold);
      T.missing_left.push_back(split.missing_go_to_left);
    }
    crit.node_value(value.data());
    T.value.insert(T.value.end(), value.begin(), value.end());

    if (!is_leaf) {
      stack.push_back({split.pos, end, depth + 1, node_id, false,
                       split.impurity_right, n_constant});
      stack.push_back({start, split.pos, depth + 1, node_id, true,
                       split.impurity_left, n_constant});
    }
  }
}

struct Forest {
  std::vector<Tree> trees;
  int value_stride;
};

}  // namespace

extern "C" {

// Build n_trees trees on the float32 rows X (n, f).  Tree t fits targets
// y + t * y_stride (class indices for Gini, values for MSE) with sample
// weights sw + t * sw_stride (a stride of 0 shares one array), its
// splitter seeded with seeds[t] (Splitter.init's rand_r_state).
// criterion: 0 Gini over n_classes, 1 MSE.  parallel_features: build the
// trees in turn, each node's drawn features scanned in parallel
// (parallel_scan); else the trees in parallel.  Returns a handle for
// ce_trees_sizes / ce_trees_copy / ce_trees_free.
void* ce_trees_build(const float* X, int64_t n, int64_t f, const double* y,
                     int64_t y_stride, const double* sw, int64_t sw_stride,
                     int64_t n_trees, int criterion, int n_classes,
                     int64_t max_features, int64_t max_depth,
                     const uint32_t* seeds, int parallel_features) {
  Forest* forest = new Forest;
  forest->trees.resize(n_trees);
  Params P{X, n, f, criterion == 0, n_classes, max_features, max_depth,
           parallel_features != 0};
  forest->value_stride = criterion == 0 ? n_classes : 1;
  if (parallel_features) {
    for (int64_t t = 0; t < n_trees; ++t)
      build_tree(P, y + t * y_stride, sw + t * sw_stride, seeds[t],
                 forest->trees[t]);
  } else {
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t t = 0; t < n_trees; ++t)
      build_tree(P, y + t * y_stride, sw + t * sw_stride, seeds[t],
                 forest->trees[t]);
  }
  return forest;
}

// Node count of every tree.
void ce_trees_sizes(void* handle, int64_t* node_count) {
  Forest* forest = static_cast<Forest*>(handle);
  for (size_t t = 0; t < forest->trees.size(); ++t)
    node_count[t] = (int64_t)forest->trees[t].left.size();
}

// Copy every tree's nodes, concatenated in tree order, into arrays of the
// summed node count (value: value_stride entries a node).  Child ids are
// local to their tree (-1 at a leaf).
void ce_trees_copy(void* handle, int64_t* left, int64_t* right,
                   int64_t* feature, double* threshold, uint8_t* missing_left,
                   double* value) {
  Forest* forest = static_cast<Forest*>(handle);
  const int vs = forest->value_stride;
  int64_t off = 0;
  for (const Tree& T : forest->trees) {
    const size_t m = T.left.size();
    std::memcpy(left + off, T.left.data(), m * sizeof(int64_t));
    std::memcpy(right + off, T.right.data(), m * sizeof(int64_t));
    std::memcpy(feature + off, T.feature.data(), m * sizeof(int64_t));
    std::memcpy(threshold + off, T.threshold.data(), m * sizeof(double));
    std::memcpy(missing_left + off, T.missing_left.data(), m);
    std::memcpy(value + off * vs, T.value.data(), m * vs * sizeof(double));
    off += (int64_t)m;
  }
}

// The feature visits the sequential loop sorts and the sorts made, summed
// over the trees: counts[0] visits, counts[1] sorts.  The sequential loop
// sorts each visit once; the parallel scan at most twice.
void ce_trees_sort_counts(void* handle, int64_t* counts) {
  Forest* forest = static_cast<Forest*>(handle);
  counts[0] = counts[1] = 0;
  for (const Tree& T : forest->trees) {
    counts[0] += T.visits;
    counts[1] += T.sorts;
  }
}

void ce_trees_free(void* handle) { delete static_cast<Forest*>(handle); }

// HalfMultinomialLoss.gradient, negated: for each row, the softmax of raw
// (max subtracted, exp, summed in class order) minus the one-hot label,
// times -1, as sklearn/_loss/_loss.pyx.tp computes it with libm's exp.
void ce_multinomial_neg_gradient(const double* raw, const double* y,
                                 int64_t n, int64_t k, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double* r = raw + i * k;
    double* o = out + i * k;
    double max_value = r[0];
    for (int64_t c = 1; c < k; ++c)
      if (r[c] > max_value) max_value = r[c];
    double sum_exps = 0.0;
    for (int64_t c = 0; c < k; ++c) {
      o[c] = std::exp(r[c] - max_value);
      sum_exps += o[c];
    }
    for (int64_t c = 0; c < k; ++c) {
      o[c] /= sum_exps;
      o[c] = -(o[c] - (y[i] == (double)c ? 1.0 : 0.0));
    }
  }
}

}  // extern "C"
