// Gradient-boosted-trees host core of consensus_entropy_tpu_torch.
//
// The port's own copy of the JAX package's native/ce_gbdt.cpp (the tree
// BUILD and forest PREDICT loops of the boosted committee slot), built by
// consensus_entropy_tpu_torch/native.py with the host compiler at first use.
// Binning, gradients and the boosting schedule live in Python
// (consensus_entropy_tpu_torch/models/gbdt.py); native.py keeps a numpy
// plain version of both loops that builds identical trees.
//
// Tree layout: complete binary heap of n_nodes = 2^(max_depth+1) - 1 slots.
// feature[i] >= 0  -> internal node; rows with bin <= threshold[i] go to
//                     child 2i+1, else 2i+2.
// feature[i] == -1 -> leaf (or never-created slot); value[i] is the leaf
//                     weight (0 for never-created slots, which are
//                     unreachable by construction).
//
// Split objective (second-order, xgboost-style):
//   gain = GL^2/(HL+lambda) + GR^2/(HR+lambda) - G^2/(H+lambda)
//   leaf weight = -G/(H+lambda)
// Ties broken toward the lowest (feature, bin) pair, matching the plain
// version's argmax-first semantics bit for bit (all accumulation in
// double, same traversal order).

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Build one depth-limited regression tree on pre-binned features.
//   Xb:   (n, f) uint8 bin codes, row-major
//   g, h: (n,) float32 gradients / hessians
//   feature, threshold: (n_nodes,) int32 outputs (caller zero/-1 init NOT
//     required; fully written here)
//   value: (n_nodes,) double output
void ce_gbdt_build_tree(const uint8_t* Xb, int64_t n, int64_t f,
                        const float* g, const float* h, int max_depth,
                        int n_bins, double lambda, double min_child_weight,
                        double min_gain, int32_t* feature, int32_t* threshold,
                        double* value) {
  const int64_t n_nodes = ((int64_t)1 << (max_depth + 1)) - 1;
  for (int64_t i = 0; i < n_nodes; ++i) {
    feature[i] = -1;
    threshold[i] = 0;
    value[i] = 0.0;
  }
  double* G = new double[n_nodes]();
  double* H = new double[n_nodes]();
  bool* open_ = new bool[n_nodes]();
  int32_t* node_of_row = new int32_t[n];
  std::memset(node_of_row, 0, n * sizeof(int32_t));

  // Row-order scratch for the per-node histogram pass (counting sort of
  // rows by node, stable in row index).
  int64_t* order = new int64_t[n];

  {
    double sg = 0.0, sh = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      sg += (double)g[i];
      sh += (double)h[i];
    }
    G[0] = sg;
    H[0] = sh;
    open_[0] = true;
  }

  // local index of each open node at the current level (-1 otherwise)
  int32_t* local = new int32_t[n_nodes];
  // previous level's histograms + local map (sibling-subtraction trick)
  double* prev_hg = nullptr;
  double* prev_hh = nullptr;
  int32_t* prev_local = new int32_t[n_nodes];

  for (int depth = 0; depth < max_depth; ++depth) {
    const int64_t lo = ((int64_t)1 << depth) - 1;
    const int64_t hi = ((int64_t)1 << (depth + 1)) - 1;
    int64_t n_act = 0;
    for (int64_t i = 0; i < n_nodes; ++i) local[i] = -1;
    for (int64_t nd = lo; nd < hi; ++nd)
      if (open_[nd]) local[nd] = (int32_t)n_act++;
    if (n_act == 0) break;

    // Histograms: (n_act, f, n_bins) of G and H, double accumulation.
    // Rows are first grouped per node (stable counting sort, so each
    // histogram cell accumulates its rows in ascending row order — the
    // exact order np.bincount uses, keeping backends bit-identical), then
    // each node's pass reads rows feature-contiguously into an
    // L2-resident (f, n_bins) slice — cache-friendly on both sides.
    //
    // Sibling subtraction: open nodes at depth >= 1 come in sibling pairs
    // (a split opens both children), and parent = left + right cell-wise,
    // so only the SMALLER child is accumulated from rows; the other is
    // derived as parent_hist - built_hist (ties build the left child).
    // Halves the expected row traffic per level; the plain version does
    // the identical subtraction, keeping backends bit-identical.
    const int64_t fb = f * n_bins;
    const int64_t hsize = n_act * fb;
    double* hg = new double[hsize]();
    double* hh = new double[hsize]();
    int64_t* start = new int64_t[n_act + 1]();
    for (int64_t i = 0; i < n; ++i) {
      const int32_t lc = local[node_of_row[i]];
      if (lc >= 0) ++start[lc + 1];
    }
    for (int64_t a = 0; a < n_act; ++a) start[a + 1] += start[a];
    {
      int64_t* fill = new int64_t[n_act];
      for (int64_t a = 0; a < n_act; ++a) fill[a] = start[a];
      for (int64_t i = 0; i < n; ++i) {
        const int32_t lc = local[node_of_row[i]];
        if (lc >= 0) order[fill[lc]++] = i;
      }
      delete[] fill;
    }
    bool* direct = new bool[n_act];
    for (int64_t nd = lo; nd < hi; ++nd) {
      const int32_t lc = local[nd];
      if (lc < 0) continue;
      if (depth == 0 || prev_hg == nullptr) {
        direct[lc] = true;
        continue;
      }
      const int64_t sib = (nd & 1) ? nd + 1 : nd - 1;
      const int32_t sl = local[sib];
      const int64_t cnt = start[lc + 1] - start[lc];
      const int64_t sib_cnt = start[sl + 1] - start[sl];
      direct[lc] = cnt < sib_cnt || (cnt == sib_cnt && (nd & 1));
    }
#pragma omp parallel for schedule(dynamic)
    for (int64_t a = 0; a < n_act; ++a) {
      if (!direct[a]) continue;
      double* hga = hg + a * fb;
      double* hha = hh + a * fb;
      for (int64_t s = start[a]; s < start[a + 1]; ++s) {
        const int64_t i = order[s];
        const uint8_t* row = Xb + i * f;
        const double gi = (double)g[i], hi = (double)h[i];
        for (int64_t j = 0; j < f; ++j) {
          const int64_t at = j * n_bins + row[j];
          hga[at] += gi;
          hha[at] += hi;
        }
      }
    }
#pragma omp parallel for schedule(static)
    for (int64_t nd = lo; nd < hi; ++nd) {
      const int32_t lc = local[nd];
      if (lc < 0 || direct[lc]) continue;
      const int64_t sib = (nd & 1) ? nd + 1 : nd - 1;
      const int64_t parent = (nd - 1) / 2;
      const double* pg = prev_hg + (int64_t)prev_local[parent] * fb;
      const double* ph = prev_hh + (int64_t)prev_local[parent] * fb;
      const double* sg_ = hg + (int64_t)local[sib] * fb;
      const double* sh_ = hh + (int64_t)local[sib] * fb;
      double* dg = hg + (int64_t)lc * fb;
      double* dh = hh + (int64_t)lc * fb;
      for (int64_t k = 0; k < fb; ++k) {
        dg[k] = pg[k] - sg_[k];
        dh[k] = ph[k] - sh_[k];
      }
    }
    delete[] direct;
    delete[] start;

    // Split search per open node (first-max tie break over (feature, bin)).
#pragma omp parallel for schedule(static)
    for (int64_t nd = lo; nd < hi; ++nd) {
      const int32_t lc = local[nd];
      if (lc < 0) continue;
      const double Gt = G[nd], Ht = H[nd];
      const double parent = Gt * Gt / (Ht + lambda);
      double best_gain = -1.0 / 0.0;
      int32_t best_f = -1, best_b = 0;
      double best_gl = 0.0, best_hl = 0.0;
      for (int64_t j = 0; j < f; ++j) {
        const double* cg = hg + ((int64_t)lc * f + j) * n_bins;
        const double* ch = hh + ((int64_t)lc * f + j) * n_bins;
        double gl = 0.0, hl = 0.0;
        for (int b = 0; b < n_bins - 1; ++b) {  // last bin: all-left, skip
          gl += cg[b];
          hl += ch[b];
          const double gr = Gt - gl, hr = Ht - hl;
          if (hl < min_child_weight || hr < min_child_weight) continue;
          const double gain =
              gl * gl / (hl + lambda) + gr * gr / (hr + lambda) - parent;
          if (gain > best_gain) {
            best_gain = gain;
            best_f = (int32_t)j;
            best_b = b;
            best_gl = gl;
            best_hl = hl;
          }
        }
      }
      if (best_f >= 0 && best_gain > min_gain) {
        feature[nd] = best_f;
        threshold[nd] = best_b;
        const int64_t l = 2 * nd + 1, r = 2 * nd + 2;
        G[l] = best_gl;
        H[l] = best_hl;
        G[r] = G[nd] - best_gl;
        H[r] = H[nd] - best_hl;
        open_[l] = true;
        open_[r] = true;
      } else {
        value[nd] = -Gt / (Ht + lambda);
      }
      open_[nd] = false;
    }
    // this level's histograms become next level's parents
    delete[] prev_hg;
    delete[] prev_hh;
    prev_hg = hg;
    prev_hh = hh;
    std::memcpy(prev_local, local, n_nodes * sizeof(int32_t));

    // Partition rows of split nodes to their children.
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const int32_t nd = node_of_row[i];
      if (nd >= lo && nd < hi && feature[nd] >= 0)
        node_of_row[i] = (int32_t)(
            2 * nd + 1 + (Xb[i * f + feature[nd]] > (uint8_t)threshold[nd]));
    }
  }

  // Max-depth level: every still-open node becomes a leaf.
  for (int64_t nd = 0; nd < n_nodes; ++nd) {
    if (open_[nd]) {
      value[nd] = -G[nd] / (H[nd] + lambda);
      open_[nd] = false;
    }
  }

  delete[] G;
  delete[] H;
  delete[] open_;
  delete[] node_of_row;
  delete[] local;
  delete[] order;
  delete[] prev_hg;
  delete[] prev_hh;
  delete[] prev_local;
}

// OpenMP team size of this calling thread's later parallel regions (an
// ICV of the calling thread: each host worker of the fleet sets its own
// share of the cores).  n <= 0 leaves the default.  Every loop above gives
// each output to one thread in a fixed order, so the team size changes no
// result.
void ce_gbdt_set_threads(int n) {
#if defined(_OPENMP)
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

// Accumulate a forest's margins:
//   margins[i, tree_class[t]] += lr * leaf_t(row i)   for every tree t.
// Trees are packed contiguously: feature/threshold (n_trees, n_nodes) int32,
// value (n_trees, n_nodes) double.  margins is (n, k) float64, caller-init.
void ce_gbdt_predict_margins(const uint8_t* Xb, int64_t n, int64_t f,
                             const int32_t* feature, const int32_t* threshold,
                             const double* value, int64_t n_trees,
                             int64_t n_nodes, const int32_t* tree_class,
                             int64_t k, double lr, double* margins) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* x = Xb + i * f;
    double* m = margins + i * k;
    for (int64_t t = 0; t < n_trees; ++t) {
      const int32_t* tf = feature + t * n_nodes;
      const int32_t* tt = threshold + t * n_nodes;
      int64_t nd = 0;
      while (tf[nd] >= 0)
        nd = 2 * nd + 1 + (x[tf[nd]] > (uint8_t)tt[nd]);
      m[tree_class[t]] += lr * value[t * n_nodes + nd];
    }
  }
}

}  // extern "C"
