// SGD host core of consensus_entropy_tpu_torch: one binary one-vs-all
// problem of the SGD committee member, scikit-learn's _plain_sgd for the
// log loss, the L2 penalty and the 'optimal' learning-rate schedule (no
// averaging, no early stopping, unit sample weights).
//
// The plain version is models/members.py::plain_sgd(..., plain=True); this
// loop does the same arithmetic in the same order, so the weights are
// identical: each product of a weight and a feature is rounded to the
// weights' type T and summed in double, wscale and the squared norm are
// kept in double, the decay factor is rounded to T, an update adds
// x * (T(update) / T(wscale)) in double and rounds to T.  Built with
// -ffp-contract=off: a fused multiply-add would round once where the plain
// version rounds twice.

#include <cmath>
#include <cstdint>
#include <limits>

namespace {

// scikit-learn's xorshift our_rand_r: the draw in [0, 2^31)
inline uint32_t our_rand_r(uint32_t* state) {
  if (*state == 0) *state = 1;
  *state ^= *state << 13;
  *state ^= *state >> 17;
  *state ^= *state << 5;
  return *state % (1u << 31);
}

// SequentialDataset.shuffle: Fisher-Yates from a fresh copy of the seed
void shuffle_index(int32_t* index, int64_t n, uint32_t seed) {
  uint32_t state = seed;
  for (int64_t i = 0; i < n - 1; ++i) {
    const uint32_t r = our_rand_r(&state);
    const int64_t j = i + static_cast<int64_t>(r % static_cast<uint32_t>(n - i));
    const int32_t tmp = index[i];
    index[i] = index[j];
    index[j] = tmp;
  }
}

inline double log1pexp(double x) {
  if (x <= -37) return std::exp(x);
  if (x <= -2) return std::log1p(std::exp(x));
  if (x <= 18) return std::log(1.0 + std::exp(x));
  if (x <= 33.3) return x + std::exp(-x);
  return x;
}

// cgradient_half_binomial: expit(p) - y in its stable form
inline double dloss_of(double y, double p) {
  if (p > -37) {
    const double e = std::exp(-p);
    return ((1 - y) - y * e) / (1 + e);
  }
  return std::exp(p) - y;
}

constexpr double kMaxDloss = 1e12;

template <typename T>
int plain_sgd(T* w, double* intercept_io, const T* X, const T* y, int64_t n,
              int64_t f, uint32_t seed, int max_iter, double t, double alpha,
              double tol, int n_iter_no_change, int shuffle, double sq_norm0,
              int32_t* index, int* epochs_out) {
  const double threshold = sizeof(T) == 4 ? 1e-6 : 1e-9;
  double intercept = *intercept_io;
  for (int64_t i = 0; i < n; ++i) index[i] = static_cast<int32_t>(i);
  double wscale = 1.0;
  const bool track = max_iter > 1;
  // the caller's np.dot(w, w) (a warm start's norm); every update below
  // recomputes it in the plain version's order
  double sq_norm = sq_norm0;
  const double typw = std::sqrt(1.0 / std::sqrt(alpha));
  const double d0 = dloss_of(1.0, -typw);
  const double initial_eta0 = typw / (d0 > 1.0 ? d0 : 1.0);
  const double optimal_init = 1.0 / (initial_eta0 * alpha);
  double best_objective = std::numeric_limits<double>::infinity();
  int no_improvement = 0;
  int epoch = 0;
  int epochs_run = 0;
  for (epoch = 0; epoch < max_iter; ++epoch) {
    epochs_run = epoch + 1;
    double objective_sum = 0.0;
    if (shuffle) shuffle_index(index, n, seed);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t k = index[i];
      const T* x = X + k * f;
      const double yk = static_cast<double>(y[k]);
      double dot = 0.0;
      for (int64_t j = 0; j < f; ++j) {
        const T prod = w[j] * x[j];
        dot += static_cast<double>(prod);
      }
      const double p = static_cast<double>(static_cast<T>(dot * wscale)) + intercept;
      const double eta = 1.0 / (alpha * (optimal_init + t - 1));
      if (track) {
        const double norm = static_cast<double>(static_cast<T>(std::sqrt(sq_norm)));
        objective_sum += log1pexp(p) - yk * p;
        objective_sum += alpha * (1.0 * 0.5 * (norm * norm));
      }
      double dloss = dloss_of(yk, p);
      if (dloss < -kMaxDloss) dloss = -kMaxDloss;
      if (kMaxDloss < dloss) dloss = kMaxDloss;
      const double update = -eta * dloss;
      const double decay = 1.0 - ((1.0 - 0.0) * eta * alpha);
      const T c = static_cast<T>(decay > 0.0 ? decay : 0.0);
      wscale *= static_cast<double>(c);
      const T cc = c * c;
      sq_norm *= static_cast<double>(cc);
      if (wscale < threshold) {
        const T ws = static_cast<T>(wscale);
        for (int64_t j = 0; j < f; ++j) w[j] = w[j] * ws;
        wscale = 1.0;
      }
      if (update != 0.0) {
        const T ws = static_cast<T>(wscale);
        const T uq = static_cast<T>(update) / ws;
        const double q = static_cast<double>(uq);
        for (int64_t j = 0; j < f; ++j) {
          const double xq = static_cast<double>(x[j]) * q;
          w[j] = static_cast<T>(static_cast<double>(w[j]) + xq);
        }
        if (track) {
          double s = 0.0;
          for (int64_t j = 0; j < f; ++j) {
            const T sq = w[j] * w[j];
            s += static_cast<double>(sq);
          }
          const T wsws = ws * ws;
          sq_norm = s * static_cast<double>(wsws);
        }
        intercept += update;
      }
      t += 1;
    }
    bool finite = std::isfinite(intercept);
    for (int64_t j = 0; finite && j < f; ++j) finite = std::isfinite(w[j]);
    if (!finite) {
      *intercept_io = intercept;
      *epochs_out = epoch + 1;
      return 1;
    }
    if (track) {
      const double objective = objective_sum / static_cast<double>(n);
      if (tol > -std::numeric_limits<double>::infinity() &&
          objective > best_objective - tol) {
        no_improvement += 1;
      } else {
        no_improvement = 0;
      }
      if (objective < best_objective) best_objective = objective;
      if (no_improvement >= n_iter_no_change) break;
    }
  }
  const T ws = static_cast<T>(wscale);
  for (int64_t j = 0; j < f; ++j) w[j] = w[j] * ws;
  *intercept_io = intercept;
  *epochs_out = epochs_run;
  return 0;
}

}  // namespace

extern "C" {

// One binary problem: w (f,) updated in place, *intercept in and out, X
// (n, f) row-major and y (n,) of 0/1 in w's type, sq_norm0 the caller's
// np.dot(w, w); index (n,) scratch.
// Returns 0, or 1 when the weights stopped being finite (*epochs holds the
// epoch, counted from 1).
int ce_sgd_plain_f32(float* w, double* intercept, const float* X,
                     const float* y, int64_t n, int64_t f, uint32_t seed,
                     int max_iter, double t, double alpha, double tol,
                     int n_iter_no_change, int shuffle, double sq_norm0,
                     int32_t* index, int* epochs) {
  return plain_sgd<float>(w, intercept, X, y, n, f, seed, max_iter, t, alpha,
                          tol, n_iter_no_change, shuffle, sq_norm0, index,
                          epochs);
}

int ce_sgd_plain_f64(double* w, double* intercept, const double* X,
                     const double* y, int64_t n, int64_t f, uint32_t seed,
                     int max_iter, double t, double alpha, double tol,
                     int n_iter_no_change, int shuffle, double sq_norm0,
                     int32_t* index, int* epochs) {
  return plain_sgd<double>(w, intercept, X, y, n, f, seed, max_iter, t,
                           alpha, tol, n_iter_no_change, shuffle, sq_norm0,
                           index, epochs);
}

}  // extern "C"
