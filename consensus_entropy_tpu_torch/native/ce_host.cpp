// The host members' predictions and the frame-to-song mean, in the
// port's host core (native.py builds it with ce_gbdt.cpp, ce_sgd.cpp,
// ce_tree.cpp and ce_svm.cpp into one library).
//
// The port's own copy of the JAX package's native/ce_host.cpp:37-148.
// Each function keeps that file's loops and accumulation order, so its
// results are the JAX package's native build's bit for bit:
//  - ce_linear_predict_proba: logits X @ W + b summed in double and
//    rounded to float; mode 0 the row softmax, mode 1 per-class sigmoids
//    L1-normalised (scikit-learn's one-vs-all predict_proba), uniform on
//    a row whose sigmoids all underflow to 0.
//  - ce_gnb_predict_proba: GaussianNB's joint log-likelihood (log prior
//    plus the Gaussian log pdfs, summed in double, the per-class constant
//    taken first) normalised by exp(jll - max) / sum; at most 64 classes.
//  - ce_segment_mean: the mean over contiguous row segments, summed in
//    double; an empty segment gives 0.
//  - ce_row_entropy: scipy.stats.entropy per row (normalise, nats,
//    0 * log 0 = 0).
//
// Every row (or segment) is computed by one OpenMP thread in a fixed
// order, so the team size changes no result; the team is the calling
// thread's (ce_gbdt_set_threads, which native.limit_threads drives).

#include <cmath>
#include <cstdint>

extern "C" {

// out (n, c) <- row softmax / row-normalised sigmoids of X (n, f) @ W (f, c)
// + b (c)
void ce_linear_predict_proba(const float* X, int64_t n, int64_t f,
                             const float* W, const float* b, int64_t c,
                             int mode, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float* x = X + i * f;
    float* o = out + i * c;
    for (int64_t k = 0; k < c; ++k) {
      double acc = b[k];
      const float* w = W + k;  // (f, c) row-major: stride c a feature
      for (int64_t j = 0; j < f; ++j) acc += (double)x[j] * (double)w[j * c];
      o[k] = (float)acc;
    }
    if (mode == 0) {  // multinomial softmax
      float m = o[0];
      for (int64_t k = 1; k < c; ++k) m = o[k] > m ? o[k] : m;
      double s = 0.0;
      for (int64_t k = 0; k < c; ++k) {
        double e = std::exp((double)o[k] - (double)m);
        o[k] = (float)e;
        s += e;
      }
      for (int64_t k = 0; k < c; ++k) o[k] = (float)((double)o[k] / s);
    } else {  // one-vs-all sigmoids, L1-normalised
      double s = 0.0;
      for (int64_t k = 0; k < c; ++k) {
        double p = 1.0 / (1.0 + std::exp(-(double)o[k]));
        o[k] = (float)p;
        s += p;
      }
      if (s > 0.0)
        for (int64_t k = 0; k < c; ++k) o[k] = (float)((double)o[k] / s);
      else
        for (int64_t k = 0; k < c; ++k) o[k] = (float)(1.0 / (double)c);
    }
  }
}

// GaussianNB: out (n, c) posteriors from theta and var (c, f) and
// log_prior (c); c <= 64 (the wrapper checks it).
void ce_gnb_predict_proba(const float* X, int64_t n, int64_t f,
                          const double* theta, const double* var,
                          const double* log_prior, int64_t c, float* out) {
  // per class: log_prior - 0.5 * sum(log(2 pi var))
  double* cls_const = new double[c];
  for (int64_t k = 0; k < c; ++k) {
    double s = 0.0;
    for (int64_t j = 0; j < f; ++j)
      s += std::log(2.0 * M_PI * var[k * f + j]);
    cls_const[k] = log_prior[k] - 0.5 * s;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float* x = X + i * f;
    float* o = out + i * c;
    double jll[64];
    double m = -1e308;
    for (int64_t k = 0; k < c; ++k) {
      const double* th = theta + k * f;
      const double* va = var + k * f;
      double s = 0.0;
      for (int64_t j = 0; j < f; ++j) {
        double d = (double)x[j] - th[j];
        s += d * d / va[j];
      }
      jll[k] = cls_const[k] - 0.5 * s;
      if (jll[k] > m) m = jll[k];
    }
    double s = 0.0;
    for (int64_t k = 0; k < c; ++k) {
      jll[k] = std::exp(jll[k] - m);
      s += jll[k];
    }
    for (int64_t k = 0; k < c; ++k) o[k] = (float)(jll[k] / s);
  }
  delete[] cls_const;
}

// The mean of X (n, c) over each segment [seg_starts[s], seg_starts[s+1])
// of the n_segs + 1 non-decreasing offsets; an empty segment gives 0.
void ce_segment_mean(const float* X, int64_t n, int64_t c,
                     const int64_t* seg_starts, int64_t n_segs, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < n_segs; ++s) {
    int64_t lo = seg_starts[s], hi = seg_starts[s + 1];
    float* o = out + s * c;
    for (int64_t k = 0; k < c; ++k) {
      double acc = 0.0;
      for (int64_t i = lo; i < hi; ++i) acc += X[i * c + k];
      o[k] = hi > lo ? (float)(acc / (double)(hi - lo)) : 0.0f;
    }
  }
  (void)n;
}

// scipy.stats.entropy per row of P (n, c): normalise, -sum(q log q) in
// nats, 0 * log 0 = 0 (a zero-sum row gives 0).
void ce_row_entropy(const float* P, int64_t n, int64_t c, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float* p = P + i * c;
    double tot = 0.0;
    for (int64_t k = 0; k < c; ++k) tot += p[k];
    double h = 0.0;
    for (int64_t k = 0; k < c; ++k) {
      if (p[k] > 0.0f) {
        double q = (double)p[k] / tot;
        h -= q * std::log(q);
      }
    }
    out[i] = (float)h;
  }
}

}  // extern "C"
