/*
Copyright (c) 2000-2009 Chih-Chung Chang and Chih-Jen Lin
All rights reserved.

Redistribution and use in source and binary forms, with or without
modification, are permitted provided that the following conditions
are met:

1. Redistributions of source code must retain the above copyright
notice, this list of conditions and the following disclaimer.

2. Redistributions in binary form must reproduce the above copyright
notice, this list of conditions and the following disclaimer in the
documentation and/or other materials provided with the distribution.

3. Neither name of copyright holders nor the names of its contributors
may be used to endorse or promote products derived from this software
without specific prior written permission.


THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
``AS IS'' AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
A PARTICULAR PURPOSE ARE DISCLAIMED.  IN NO EVENT SHALL THE REGENTS OR
CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL,
EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO,
PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
*/

// RBF C-SVC host core of consensus_entropy_tpu_torch: libsvm's training as
// scikit-learn 1.9.0 runs it for SVC(probability=True) on dense rows
// (sklearn/svm/src/libsvm/svm.cpp, carried over with its dense
// representation, scikit-learn's per-instance weights, sorted labels and
// its mt19937 bounded_rand_int from sklearn/svm/src/newrand/newrand.h).
// Kept: the kernel cache, Solver with second-order working-set selection
// and shrinking, svm_train_one, one-vs-one training over
// svm_group_classes order, svm_binary_svc_probability's 5-fold Platt
// scaling (its random shuffle, the sub-model's decision values) and
// sigmoid_train.  Left out: the other SVM and kernel types.
//
// Differences from that code: a dot product of two rows is one sequential
// loop in double where scikit-learn calls the BLAS ddot, so kernel values
// can differ in the last bits; the random generator is one a call (not a
// process global); the one-vs-one pairs are solved in an OpenMP loop,
// each from the generator state the sequential order gives it, so the
// model does not depend on the team size.  The plain version is
// models/svm_fit.py.

#include <cmath>
#include <cfloat>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

typedef float Qfloat;
typedef signed char schar;

#define INF HUGE_VAL
#define TAU 1e-12
#define Malloc(type, n) (type*)malloc((n) * sizeof(type))

template <class T> static inline T min_(T x, T y) { return (x < y) ? x : y; }
template <class T> static inline T max_(T x, T y) { return (x > y) ? x : y; }
template <class T> static inline void swap_(T& x, T& y) {
  T t = x;
  x = y;
  y = t;
}
template <class S, class T> static inline void clone(T*& dst, S* src, int n) {
  dst = new T[n];
  memcpy((void*)dst, (void*)src, sizeof(T) * n);
}

// newrand.h's bounded_rand_int on a given generator
inline uint32_t bounded_rand_int(std::mt19937& mt_rand, uint32_t range) {
  uint32_t x = mt_rand();
  uint64_t m = uint64_t(x) * uint64_t(range);
  uint32_t l = uint32_t(m);
  if (l < range) {
    uint32_t t = -range;
    if (t >= range) {
      t -= range;
      if (t >= range) t %= range;
    }
    while (l < t) {
      x = mt_rand();
      m = uint64_t(x) * uint64_t(range);
      l = uint32_t(m);
    }
  }
  return m >> 32;
}

struct Node {  // a dense row
  int dim;
  int ind;  // the row's index in the problem given to svm_train
  const double* values;
};

struct Problem {
  int l;
  const double* y;
  Node* x;
  const double* W;
};

struct Param {
  double gamma, C, eps, cache_size;
  int shrinking, probability, max_iter;
  int nr_weight;
  int weight_label[2];
  double weight[2];
};

struct Model {
  int nr_class = 0, l = 0;
  std::vector<Node> SV;
  std::vector<int> sv_ind, label, nSV, n_iter;
  std::vector<std::vector<double>> sv_coef;
  std::vector<double> rho, probA, probB;
};

static double dot(const Node* px, const Node* py) {
  double sum = 0;
  int dim = min_(px->dim, py->dim);
  for (int i = 0; i < dim; ++i) sum += px->values[i] * py->values[i];
  return sum;
}

//
// Kernel Cache
//
class Cache {
 public:
  Cache(int l, long int size);
  ~Cache();
  int get_data(const int index, Qfloat** data, int len);
  void swap_index(int i, int j);

 private:
  int l;
  long int size;
  struct head_t {
    head_t *prev, *next;
    Qfloat* data;
    int len;
  };
  head_t* head;
  head_t lru_head;
  void lru_delete(head_t* h);
  void lru_insert(head_t* h);
};

Cache::Cache(int l_, long int size_) : l(l_), size(size_) {
  head = (head_t*)calloc(l, sizeof(head_t));
  size /= sizeof(Qfloat);
  size -= l * sizeof(head_t) / sizeof(Qfloat);
  size = max_(size, 2 * (long int)l);
  lru_head.next = lru_head.prev = &lru_head;
}

Cache::~Cache() {
  for (head_t* h = lru_head.next; h != &lru_head; h = h->next) free(h->data);
  free(head);
}

void Cache::lru_delete(head_t* h) {
  h->prev->next = h->next;
  h->next->prev = h->prev;
}

void Cache::lru_insert(head_t* h) {
  h->next = &lru_head;
  h->prev = lru_head.prev;
  h->prev->next = h;
  h->next->prev = h;
}

int Cache::get_data(const int index, Qfloat** data, int len) {
  head_t* h = &head[index];
  if (h->len) lru_delete(h);
  int more = len - h->len;
  if (more > 0) {
    while (size < more) {
      head_t* old = lru_head.next;
      lru_delete(old);
      free(old->data);
      size += old->len;
      old->data = 0;
      old->len = 0;
    }
    h->data = (Qfloat*)realloc(h->data, sizeof(Qfloat) * len);
    size -= more;
    swap_(h->len, len);
  }
  lru_insert(h);
  *data = h->data;
  return len;
}

void Cache::swap_index(int i, int j) {
  if (i == j) return;
  if (head[i].len) lru_delete(&head[i]);
  if (head[j].len) lru_delete(&head[j]);
  swap_(head[i].data, head[j].data);
  swap_(head[i].len, head[j].len);
  if (head[i].len) lru_insert(&head[i]);
  if (head[j].len) lru_insert(&head[j]);
  if (i > j) swap_(i, j);
  for (head_t* h = lru_head.next; h != &lru_head; h = h->next) {
    if (h->len > i) {
      if (h->len > j) {
        swap_(h->data[i], h->data[j]);
      } else {
        lru_delete(h);
        free(h->data);
        size += h->len;
        h->data = 0;
        h->len = 0;
      }
    }
  }
}

//
// Kernel evaluation (RBF)
//
class QMatrix {
 public:
  virtual Qfloat* get_Q(int column, int len) const = 0;
  virtual double* get_QD() const = 0;
  virtual void swap_index(int i, int j) const = 0;
  virtual ~QMatrix() {}
};

class Kernel : public QMatrix {
 public:
  Kernel(int l, Node* x_, const Param& param) : gamma(param.gamma) {
    clone(x, x_, l);
    x_square = new double[l];
    for (int i = 0; i < l; i++) x_square[i] = dot(x + i, x + i);
  }
  virtual ~Kernel() {
    delete[] x;
    delete[] x_square;
  }
  static double k_function(const Node* x, const Node* y, const Param& param) {
    double sum = 0;
    int dim = min_(x->dim, y->dim), i;
    std::vector<double> m_array(dim);
    for (i = 0; i < dim; i++) m_array[i] = x->values[i] - y->values[i];
    for (int k = 0; k < dim; ++k) sum += m_array[k] * m_array[k];
    for (; i < x->dim; i++) sum += x->values[i] * x->values[i];
    for (; i < y->dim; i++) sum += y->values[i] * y->values[i];
    return exp(-param.gamma * sum);
  }
  virtual void swap_index(int i, int j) const {
    swap_(x[i], x[j]);
    swap_(x_square[i], x_square[j]);
  }

 protected:
  double kernel_rbf(int i, int j) const {
    return exp(-gamma * (x_square[i] + x_square[j] - 2 * dot(x + i, x + j)));
  }

 private:
  Node* x;
  double* x_square;
  const double gamma;
};

class SVC_Q : public Kernel {
 public:
  SVC_Q(const Problem& prob, const Param& param, const schar* y_)
      : Kernel(prob.l, prob.x, param) {
    clone(y, y_, prob.l);
    cache = new Cache(prob.l, (long int)(param.cache_size * (1 << 20)));
    QD = new double[prob.l];
    for (int i = 0; i < prob.l; i++) QD[i] = kernel_rbf(i, i);
  }
  Qfloat* get_Q(int i, int len) const {
    Qfloat* data;
    int start, j;
    if ((start = cache->get_data(i, &data, len)) < len) {
      for (j = start; j < len; j++)
        data[j] = (Qfloat)(y[i] * y[j] * kernel_rbf(i, j));
    }
    return data;
  }
  double* get_QD() const { return QD; }
  void swap_index(int i, int j) const {
    cache->swap_index(i, j);
    Kernel::swap_index(i, j);
    swap_(y[i], y[j]);
    swap_(QD[i], QD[j]);
  }
  ~SVC_Q() {
    delete[] y;
    delete cache;
    delete[] QD;
  }

 private:
  schar* y;
  Cache* cache;
  double* QD;
};

// An SMO algorithm based on: R.-E. Fan, P.-H. Chen, and C.-J. Lin. Working
// set selection using second order information for training support vector
// machines. JMLR 6 (2005), p. 1889--1918.
class Solver {
 public:
  struct SolutionInfo {
    double obj;
    double rho;
    double* upper_bound;
    bool solve_timed_out;
    int n_iter;
  };
  void Solve(int l, const QMatrix& Q, const double* p_, const schar* y_,
             double* alpha_, const double* C_, double eps, SolutionInfo* si,
             int shrinking, int max_iter);

 protected:
  int active_size;
  schar* y;
  double* G;
  enum { LOWER_BOUND, UPPER_BOUND, FREE };
  char* alpha_status;
  double* alpha;
  const QMatrix* Q;
  const double* QD;
  double eps;
  double* C;
  double* p;
  int* active_set;
  double* G_bar;
  int l;
  bool unshrink;

  double get_C(int i) { return C[i]; }
  void update_alpha_status(int i) {
    if (alpha[i] >= get_C(i)) alpha_status[i] = UPPER_BOUND;
    else if (alpha[i] <= 0) alpha_status[i] = LOWER_BOUND;
    else alpha_status[i] = FREE;
  }
  bool is_upper_bound(int i) { return alpha_status[i] == UPPER_BOUND; }
  bool is_lower_bound(int i) { return alpha_status[i] == LOWER_BOUND; }
  bool is_free(int i) { return alpha_status[i] == FREE; }
  void swap_index(int i, int j);
  void reconstruct_gradient();
  int select_working_set(int& i, int& j);
  double calculate_rho();
  void do_shrinking();
  bool be_shrunk(int i, double Gmax1, double Gmax2);
};

void Solver::swap_index(int i, int j) {
  Q->swap_index(i, j);
  swap_(y[i], y[j]);
  swap_(G[i], G[j]);
  swap_(alpha_status[i], alpha_status[j]);
  swap_(alpha[i], alpha[j]);
  swap_(p[i], p[j]);
  swap_(active_set[i], active_set[j]);
  swap_(G_bar[i], G_bar[j]);
  swap_(C[i], C[j]);
}

void Solver::reconstruct_gradient() {
  if (active_size == l) return;
  int i, j;
  int nr_free = 0;
  for (j = active_size; j < l; j++) G[j] = G_bar[j] + p[j];
  for (j = 0; j < active_size; j++)
    if (is_free(j)) nr_free++;
  if (nr_free * l > 2 * active_size * (l - active_size)) {
    for (i = active_size; i < l; i++) {
      const Qfloat* Q_i = Q->get_Q(i, active_size);
      for (j = 0; j < active_size; j++)
        if (is_free(j)) G[i] += alpha[j] * Q_i[j];
    }
  } else {
    for (i = 0; i < active_size; i++)
      if (is_free(i)) {
        const Qfloat* Q_i = Q->get_Q(i, l);
        double alpha_i = alpha[i];
        for (j = active_size; j < l; j++) G[j] += alpha_i * Q_i[j];
      }
  }
}

void Solver::Solve(int l, const QMatrix& Q, const double* p_, const schar* y_,
                   double* alpha_, const double* C_, double eps,
                   SolutionInfo* si, int shrinking, int max_iter) {
  this->l = l;
  this->Q = &Q;
  QD = Q.get_QD();
  clone(p, p_, l);
  clone(y, y_, l);
  clone(alpha, alpha_, l);
  clone(C, C_, l);
  this->eps = eps;
  unshrink = false;
  si->solve_timed_out = false;
  {
    alpha_status = new char[l];
    for (int i = 0; i < l; i++) update_alpha_status(i);
  }
  {
    active_set = new int[l];
    for (int i = 0; i < l; i++) active_set[i] = i;
    active_size = l;
  }
  {
    G = new double[l];
    G_bar = new double[l];
    int i;
    for (i = 0; i < l; i++) {
      G[i] = p[i];
      G_bar[i] = 0;
    }
    for (i = 0; i < l; i++)
      if (!is_lower_bound(i)) {
        const Qfloat* Q_i = Q.get_Q(i, l);
        double alpha_i = alpha[i];
        int j;
        for (j = 0; j < l; j++) G[j] += alpha_i * Q_i[j];
        if (is_upper_bound(i))
          for (j = 0; j < l; j++) G_bar[j] += get_C(i) * Q_i[j];
      }
  }

  int iter = 0;
  int counter = min_(l, 1000) + 1;
  while (1) {
    if ((max_iter != -1) && (iter >= max_iter)) {
      si->solve_timed_out = true;
      break;
    }
    if (--counter == 0) {
      counter = min_(l, 1000);
      if (shrinking) do_shrinking();
    }
    int i, j;
    if (select_working_set(i, j) != 0) {
      reconstruct_gradient();
      active_size = l;
      if (select_working_set(i, j) != 0)
        break;
      else
        counter = 1;
    }
    ++iter;

    const Qfloat* Q_i = Q.get_Q(i, active_size);
    const Qfloat* Q_j = Q.get_Q(j, active_size);
    double C_i = get_C(i);
    double C_j = get_C(j);
    double old_alpha_i = alpha[i];
    double old_alpha_j = alpha[j];

    if (y[i] != y[j]) {
      double quad_coef = QD[i] + QD[j] + 2 * Q_i[j];
      if (quad_coef <= 0) quad_coef = TAU;
      double delta = (-G[i] - G[j]) / quad_coef;
      double diff = alpha[i] - alpha[j];
      alpha[i] += delta;
      alpha[j] += delta;
      if (diff > 0) {
        if (alpha[j] < 0) {
          alpha[j] = 0;
          alpha[i] = diff;
        }
      } else {
        if (alpha[i] < 0) {
          alpha[i] = 0;
          alpha[j] = -diff;
        }
      }
      if (diff > C_i - C_j) {
        if (alpha[i] > C_i) {
          alpha[i] = C_i;
          alpha[j] = C_i - diff;
        }
      } else {
        if (alpha[j] > C_j) {
          alpha[j] = C_j;
          alpha[i] = C_j + diff;
        }
      }
    } else {
      double quad_coef = QD[i] + QD[j] - 2 * Q_i[j];
      if (quad_coef <= 0) quad_coef = TAU;
      double delta = (G[i] - G[j]) / quad_coef;
      double sum = alpha[i] + alpha[j];
      alpha[i] -= delta;
      alpha[j] += delta;
      if (sum > C_i) {
        if (alpha[i] > C_i) {
          alpha[i] = C_i;
          alpha[j] = sum - C_i;
        }
      } else {
        if (alpha[j] < 0) {
          alpha[j] = 0;
          alpha[i] = sum;
        }
      }
      if (sum > C_j) {
        if (alpha[j] > C_j) {
          alpha[j] = C_j;
          alpha[i] = sum - C_j;
        }
      } else {
        if (alpha[i] < 0) {
          alpha[i] = 0;
          alpha[j] = sum;
        }
      }
    }

    double delta_alpha_i = alpha[i] - old_alpha_i;
    double delta_alpha_j = alpha[j] - old_alpha_j;
    for (int k = 0; k < active_size; k++)
      G[k] += Q_i[k] * delta_alpha_i + Q_j[k] * delta_alpha_j;

    {
      bool ui = is_upper_bound(i);
      bool uj = is_upper_bound(j);
      update_alpha_status(i);
      update_alpha_status(j);
      int k;
      if (ui != is_upper_bound(i)) {
        Q_i = Q.get_Q(i, l);
        if (ui)
          for (k = 0; k < l; k++) G_bar[k] -= C_i * Q_i[k];
        else
          for (k = 0; k < l; k++) G_bar[k] += C_i * Q_i[k];
      }
      if (uj != is_upper_bound(j)) {
        Q_j = Q.get_Q(j, l);
        if (uj)
          for (k = 0; k < l; k++) G_bar[k] -= C_j * Q_j[k];
        else
          for (k = 0; k < l; k++) G_bar[k] += C_j * Q_j[k];
      }
    }
  }

  si->rho = calculate_rho();
  {
    double v = 0;
    for (int i = 0; i < l; i++) v += alpha[i] * (G[i] + p[i]);
    si->obj = v / 2;
  }
  for (int i = 0; i < l; i++) alpha_[active_set[i]] = alpha[i];
  for (int i = 0; i < l; i++) si->upper_bound[i] = C[i];
  si->n_iter = iter;

  delete[] p;
  delete[] y;
  delete[] alpha;
  delete[] alpha_status;
  delete[] active_set;
  delete[] G;
  delete[] G_bar;
  delete[] C;
}

int Solver::select_working_set(int& out_i, int& out_j) {
  double Gmax = -INF;
  double Gmax2 = -INF;
  int Gmax_idx = -1;
  int Gmin_idx = -1;
  double obj_diff_min = INF;

  for (int t = 0; t < active_size; t++)
    if (y[t] == +1) {
      if (!is_upper_bound(t))
        if (-G[t] >= Gmax) {
          Gmax = -G[t];
          Gmax_idx = t;
        }
    } else {
      if (!is_lower_bound(t))
        if (G[t] >= Gmax) {
          Gmax = G[t];
          Gmax_idx = t;
        }
    }

  int i = Gmax_idx;
  const Qfloat* Q_i = NULL;
  if (i != -1) Q_i = Q->get_Q(i, active_size);

  for (int j = 0; j < active_size; j++) {
    if (y[j] == +1) {
      if (!is_lower_bound(j)) {
        double grad_diff = Gmax + G[j];
        if (G[j] >= Gmax2) Gmax2 = G[j];
        if (grad_diff > 0) {
          double obj_diff;
          double quad_coef = QD[i] + QD[j] - 2.0 * y[i] * Q_i[j];
          if (quad_coef > 0)
            obj_diff = -(grad_diff * grad_diff) / quad_coef;
          else
            obj_diff = -(grad_diff * grad_diff) / TAU;
          if (obj_diff <= obj_diff_min) {
            Gmin_idx = j;
            obj_diff_min = obj_diff;
          }
        }
      }
    } else {
      if (!is_upper_bound(j)) {
        double grad_diff = Gmax - G[j];
        if (-G[j] >= Gmax2) Gmax2 = -G[j];
        if (grad_diff > 0) {
          double obj_diff;
          double quad_coef = QD[i] + QD[j] + 2.0 * y[i] * Q_i[j];
          if (quad_coef > 0)
            obj_diff = -(grad_diff * grad_diff) / quad_coef;
          else
            obj_diff = -(grad_diff * grad_diff) / TAU;
          if (obj_diff <= obj_diff_min) {
            Gmin_idx = j;
            obj_diff_min = obj_diff;
          }
        }
      }
    }
  }

  if (Gmax + Gmax2 < eps || Gmin_idx == -1) return 1;
  out_i = Gmax_idx;
  out_j = Gmin_idx;
  return 0;
}

bool Solver::be_shrunk(int i, double Gmax1, double Gmax2) {
  if (is_upper_bound(i)) {
    if (y[i] == +1)
      return (-G[i] > Gmax1);
    else
      return (-G[i] > Gmax2);
  } else if (is_lower_bound(i)) {
    if (y[i] == +1)
      return (G[i] > Gmax2);
    else
      return (G[i] > Gmax1);
  } else {
    return (false);
  }
}

void Solver::do_shrinking() {
  int i;
  double Gmax1 = -INF;
  double Gmax2 = -INF;
  for (i = 0; i < active_size; i++) {
    if (y[i] == +1) {
      if (!is_upper_bound(i)) {
        if (-G[i] >= Gmax1) Gmax1 = -G[i];
      }
      if (!is_lower_bound(i)) {
        if (G[i] >= Gmax2) Gmax2 = G[i];
      }
    } else {
      if (!is_upper_bound(i)) {
        if (-G[i] >= Gmax2) Gmax2 = -G[i];
      }
      if (!is_lower_bound(i)) {
        if (G[i] >= Gmax1) Gmax1 = G[i];
      }
    }
  }
  if (unshrink == false && Gmax1 + Gmax2 <= eps * 10) {
    unshrink = true;
    reconstruct_gradient();
    active_size = l;
  }
  for (i = 0; i < active_size; i++)
    if (be_shrunk(i, Gmax1, Gmax2)) {
      active_size--;
      while (active_size > i) {
        if (!be_shrunk(active_size, Gmax1, Gmax2)) {
          swap_index(i, active_size);
          break;
        }
        active_size--;
      }
    }
}

double Solver::calculate_rho() {
  double r;
  int nr_free = 0;
  double ub = INF, lb = -INF, sum_free = 0;
  for (int i = 0; i < active_size; i++) {
    double yG = y[i] * G[i];
    if (is_upper_bound(i)) {
      if (y[i] == -1)
        ub = min_(ub, yG);
      else
        lb = max_(lb, yG);
    } else if (is_lower_bound(i)) {
      if (y[i] == +1)
        ub = min_(ub, yG);
      else
        lb = max_(lb, yG);
    } else {
      ++nr_free;
      sum_free += yG;
    }
  }
  if (nr_free > 0)
    r = sum_free / nr_free;
  else
    r = (ub + lb) / 2;
  return r;
}

static void solve_c_svc(const Problem* prob, const Param* param, double* alpha,
                        Solver::SolutionInfo* si, double Cp, double Cn) {
  int l = prob->l;
  double* minus_ones = new double[l];
  schar* y = new schar[l];
  double* C = new double[l];
  int i;
  for (i = 0; i < l; i++) {
    alpha[i] = 0;
    minus_ones[i] = -1;
    if (prob->y[i] > 0) {
      y[i] = +1;
      C[i] = prob->W[i] * Cp;
    } else {
      y[i] = -1;
      C[i] = prob->W[i] * Cn;
    }
  }
  Solver s;
  s.Solve(l, SVC_Q(*prob, *param, y), minus_ones, y, alpha, C, param->eps, si,
          param->shrinking, param->max_iter);
  for (i = 0; i < l; i++) alpha[i] *= y[i];
  delete[] C;
  delete[] minus_ones;
  delete[] y;
}

struct decision_function {
  double* alpha;
  double rho;
  int n_iter;
};

static decision_function svm_train_one(const Problem* prob,
                                       const Param* param, double Cp,
                                       double Cn, int* status) {
  double* alpha = Malloc(double, prob->l);
  Solver::SolutionInfo si;
  si.upper_bound = Malloc(double, prob->l);
  solve_c_svc(prob, param, alpha, &si, Cp, Cn);
  *status |= si.solve_timed_out;
  free(si.upper_bound);
  decision_function f;
  f.alpha = alpha;
  f.rho = si.rho;
  f.n_iter = si.n_iter;
  return f;
}

// Platt's binary SVM Probabilistic Output: an improvement from Lin et al.
static void sigmoid_train(int l, const double* dec_values,
                          const double* labels, double& A, double& B) {
  double prior1 = 0, prior0 = 0;
  int i;
  for (i = 0; i < l; i++)
    if (labels[i] > 0)
      prior1 += 1;
    else
      prior0 += 1;

  int max_iter = 100;
  double min_step = 1e-10;
  double sigma = 1e-12;
  double eps = 1e-5;
  double hiTarget = (prior1 + 1.0) / (prior1 + 2.0);
  double loTarget = 1 / (prior0 + 2.0);
  double* t = Malloc(double, l);
  double fApB, p, q, h11, h22, h21, g1, g2, det, dA, dB, gd, stepsize;
  double newA, newB, newf, d1, d2;
  int iter;

  A = 0.0;
  B = log((prior0 + 1.0) / (prior1 + 1.0));
  double fval = 0.0;
  for (i = 0; i < l; i++) {
    if (labels[i] > 0)
      t[i] = hiTarget;
    else
      t[i] = loTarget;
    fApB = dec_values[i] * A + B;
    if (fApB >= 0)
      fval += t[i] * fApB + log(1 + exp(-fApB));
    else
      fval += (t[i] - 1) * fApB + log(1 + exp(fApB));
  }
  for (iter = 0; iter < max_iter; iter++) {
    h11 = sigma;
    h22 = sigma;
    h21 = 0.0;
    g1 = 0.0;
    g2 = 0.0;
    for (i = 0; i < l; i++) {
      fApB = dec_values[i] * A + B;
      if (fApB >= 0) {
        p = exp(-fApB) / (1.0 + exp(-fApB));
        q = 1.0 / (1.0 + exp(-fApB));
      } else {
        p = 1.0 / (1.0 + exp(fApB));
        q = exp(fApB) / (1.0 + exp(fApB));
      }
      d2 = p * q;
      h11 += dec_values[i] * dec_values[i] * d2;
      h22 += d2;
      h21 += dec_values[i] * d2;
      d1 = t[i] - p;
      g1 += dec_values[i] * d1;
      g2 += d1;
    }
    if (fabs(g1) < eps && fabs(g2) < eps) break;
    det = h11 * h22 - h21 * h21;
    dA = -(h22 * g1 - h21 * g2) / det;
    dB = -(-h21 * g1 + h11 * g2) / det;
    gd = g1 * dA + g2 * dB;
    stepsize = 1;
    while (stepsize >= min_step) {
      newA = A + stepsize * dA;
      newB = B + stepsize * dB;
      newf = 0.0;
      for (i = 0; i < l; i++) {
        fApB = dec_values[i] * newA + newB;
        if (fApB >= 0)
          newf += t[i] * fApB + log(1 + exp(-fApB));
        else
          newf += (t[i] - 1) * fApB + log(1 + exp(fApB));
      }
      if (newf < fval + 0.0001 * stepsize * gd) {
        A = newA;
        B = newB;
        fval = newf;
        break;
      } else {
        stepsize = stepsize / 2.0;
      }
    }
    if (stepsize < min_step) break;
  }
  free(t);
}

static void svm_group_classes(const Problem* prob, int* nr_class_ret,
                              std::vector<int>& label, std::vector<int>& start,
                              std::vector<int>& count, int* perm) {
  int l = prob->l;
  int nr_class = 0;
  std::vector<int> data_label(l);
  int i, j, this_label, this_count;
  label.clear();
  count.clear();
  for (i = 0; i < l; i++) {
    this_label = (int)prob->y[i];
    for (j = 0; j < nr_class; j++) {
      if (this_label == label[j]) {
        ++count[j];
        break;
      }
    }
    if (j == nr_class) {
      label.push_back(this_label);
      count.push_back(1);
      ++nr_class;
    }
  }
  for (j = 1; j < nr_class; j++) {
    i = j - 1;
    this_label = label[j];
    this_count = count[j];
    while (i >= 0 && label[i] > this_label) {
      label[i + 1] = label[i];
      count[i + 1] = count[i];
      i--;
    }
    label[i + 1] = this_label;
    count[i + 1] = this_count;
  }
  for (i = 0; i < l; i++) {
    j = 0;
    this_label = (int)prob->y[i];
    while (this_label != label[j]) j++;
    data_label[i] = j;
  }
  start.assign(nr_class, 0);
  for (i = 1; i < nr_class; i++) start[i] = start[i - 1] + count[i - 1];
  for (i = 0; i < l; i++) {
    perm[start[data_label[i]]] = i;
    ++start[data_label[i]];
  }
  start[0] = 0;
  for (i = 1; i < nr_class; i++) start[i] = start[i - 1] + count[i - 1];
  *nr_class_ret = nr_class;
}

static void svm_predict_values(const Model* model, const Node* x,
                               double* dec_values, const Param& param) {
  int nr_class = model->nr_class;
  int l = model->l;
  std::vector<double> kvalue(l);
  for (int i = 0; i < l; i++)
    kvalue[i] = Kernel::k_function(x, &model->SV[i], param);
  std::vector<int> start(nr_class);
  start[0] = 0;
  for (int i = 1; i < nr_class; i++)
    start[i] = start[i - 1] + model->nSV[i - 1];
  int p = 0;
  for (int i = 0; i < nr_class; i++)
    for (int j = i + 1; j < nr_class; j++) {
      double sum = 0;
      int si = start[i];
      int sj = start[j];
      int ci = model->nSV[i];
      int cj = model->nSV[j];
      int k;
      const double* coef1 = model->sv_coef[j - 1].data();
      const double* coef2 = model->sv_coef[i].data();
      for (k = 0; k < ci; k++) sum += coef1[si + k] * kvalue[si + k];
      for (k = 0; k < cj; k++) sum += coef2[sj + k] * kvalue[sj + k];
      sum -= model->rho[p];
      dec_values[p] = sum;
      p++;
    }
}

struct PairPlan {  // the random shuffle a pair's probability fit draws
  std::vector<int> perm;
};

static Model* svm_train(const Problem* prob, const Param* param, int* status,
                        const PairPlan* plans);

// svm_binary_svc_probability with its random shuffle given
static void svm_binary_svc_probability(const Problem* prob, const Param* param,
                                       double Cp, double Cn, double& probA,
                                       double& probB, int* status,
                                       const std::vector<int>& perm) {
  int i;
  int nr_fold = 5;
  std::vector<double> dec_values(prob->l);
  for (i = 0; i < nr_fold; i++) {
    int begin = i * prob->l / nr_fold;
    int end = (i + 1) * prob->l / nr_fold;
    int j, k;
    Problem subprob;
    subprob.l = prob->l - (end - begin);
    std::vector<Node> sx(subprob.l);
    std::vector<double> sy(subprob.l), sW(subprob.l);
    k = 0;
    for (j = 0; j < begin; j++) {
      sx[k] = prob->x[perm[j]];
      sy[k] = prob->y[perm[j]];
      sW[k] = prob->W[perm[j]];
      ++k;
    }
    for (j = end; j < prob->l; j++) {
      sx[k] = prob->x[perm[j]];
      sy[k] = prob->y[perm[j]];
      sW[k] = prob->W[perm[j]];
      ++k;
    }
    subprob.x = sx.data();
    subprob.y = sy.data();
    subprob.W = sW.data();
    int p_count = 0, n_count = 0;
    for (j = 0; j < k; j++)
      if (subprob.y[j] > 0)
        p_count++;
      else
        n_count++;
    if (p_count == 0 && n_count == 0)
      for (j = begin; j < end; j++) dec_values[perm[j]] = 0;
    else if (p_count > 0 && n_count == 0)
      for (j = begin; j < end; j++) dec_values[perm[j]] = 1;
    else if (p_count == 0 && n_count > 0)
      for (j = begin; j < end; j++) dec_values[perm[j]] = -1;
    else {
      Param subparam = *param;
      subparam.probability = 0;
      subparam.C = 1.0;
      subparam.nr_weight = 2;
      subparam.weight_label[0] = +1;
      subparam.weight_label[1] = -1;
      subparam.weight[0] = Cp;
      subparam.weight[1] = Cn;
      Model* submodel = svm_train(&subprob, &subparam, status, nullptr);
      for (j = begin; j < end; j++) {
        svm_predict_values(submodel, prob->x + perm[j], &dec_values[perm[j]],
                           subparam);
        dec_values[perm[j]] *= submodel->label[0];
      }
      delete submodel;
    }
  }
  sigmoid_train(prob->l, dec_values.data(), prob->y, probA, probB);
}

// svm_train for C_SVC; a probability fit takes each pair's shuffle from
// plans (drawn in the sequential order by ce_svc_train)
static Model* svm_train(const Problem* prob, const Param* param, int* status,
                        const PairPlan* plans) {
  // every weight is positive here (the Python side checks), so
  // remove_zero_weight keeps the problem as it is
  Model* model = new Model;
  int l = prob->l;
  int nr_class;
  std::vector<int> label, start, count;
  std::vector<int> perm(l);
  svm_group_classes(prob, &nr_class, label, start, count, perm.data());
  std::vector<Node> x(l);
  std::vector<double> W(l);
  int i;
  for (i = 0; i < l; i++) {
    x[i] = prob->x[perm[i]];
    W[i] = prob->W[perm[i]];
  }
  std::vector<double> weighted_C(nr_class, param->C);
  for (i = 0; i < param->nr_weight; i++) {
    int j;
    for (j = 0; j < nr_class; j++)
      if (param->weight_label[i] == label[j]) break;
    if (j != nr_class) weighted_C[j] *= param->weight[i];
  }
  std::vector<char> nonzero(l, 0);
  const int n_pairs = nr_class * (nr_class - 1) / 2;
  std::vector<decision_function> f(n_pairs);
  std::vector<double> probA(n_pairs), probB(n_pairs);
  std::vector<int> pi(n_pairs), pj(n_pairs), pstatus(n_pairs, 0);
  {
    int p = 0;
    for (i = 0; i < nr_class; i++)
      for (int j = i + 1; j < nr_class; j++, p++) {
        pi[p] = i;
        pj[p] = j;
      }
  }
  // the pairs are independent given their shuffles: solve them in parallel
#pragma omp parallel for schedule(dynamic, 1) if (plans != nullptr)
  for (int p = 0; p < n_pairs; ++p) {
    int i = pi[p], j = pj[p];
    Problem sub_prob;
    int si = start[i], sj = start[j];
    int ci = count[i], cj = count[j];
    sub_prob.l = ci + cj;
    std::vector<Node> sx(sub_prob.l);
    std::vector<double> sy(sub_prob.l), sW(sub_prob.l);
    int k;
    for (k = 0; k < ci; k++) {
      sx[k] = x[si + k];
      sy[k] = +1;
      sW[k] = W[si + k];
    }
    for (k = 0; k < cj; k++) {
      sx[ci + k] = x[sj + k];
      sy[ci + k] = -1;
      sW[ci + k] = W[sj + k];
    }
    sub_prob.x = sx.data();
    sub_prob.y = sy.data();
    sub_prob.W = sW.data();
    if (param->probability)
      svm_binary_svc_probability(&sub_prob, param, weighted_C[i],
                                 weighted_C[j], probA[p], probB[p],
                                 &pstatus[p], plans[p].perm);
    f[p] = svm_train_one(&sub_prob, param, weighted_C[i], weighted_C[j],
                         &pstatus[p]);
  }
  for (int p = 0; p < n_pairs; ++p) {
    int i = pi[p], j = pj[p];
    int si = start[i], sj = start[j];
    int ci = count[i], cj = count[j];
    *status |= pstatus[p];
    for (int k = 0; k < ci; k++)
      if (!nonzero[si + k] && fabs(f[p].alpha[k]) > 0) nonzero[si + k] = 1;
    for (int k = 0; k < cj; k++)
      if (!nonzero[sj + k] && fabs(f[p].alpha[ci + k]) > 0)
        nonzero[sj + k] = 1;
  }

  model->nr_class = nr_class;
  model->label = label;
  model->rho.resize(n_pairs);
  model->n_iter.resize(n_pairs);
  for (i = 0; i < n_pairs; i++) {
    model->rho[i] = f[i].rho;
    model->n_iter[i] = f[i].n_iter;
  }
  if (param->probability) {
    model->probA = probA;
    model->probB = probB;
  }
  int total_sv = 0;
  std::vector<int> nz_count(nr_class);
  model->nSV.resize(nr_class);
  for (i = 0; i < nr_class; i++) {
    int nSV = 0;
    for (int j = 0; j < count[i]; j++)
      if (nonzero[start[i] + j]) {
        ++nSV;
        ++total_sv;
      }
    model->nSV[i] = nSV;
    nz_count[i] = nSV;
  }
  model->l = total_sv;
  model->sv_ind.resize(total_sv);
  model->SV.resize(total_sv);
  {
    int p = 0;
    for (i = 0; i < l; i++)
      if (nonzero[i]) {
        model->SV[p] = x[i];
        model->sv_ind[p] = perm[i];
        ++p;
      }
  }
  std::vector<int> nz_start(nr_class);
  nz_start[0] = 0;
  for (i = 1; i < nr_class; i++)
    nz_start[i] = nz_start[i - 1] + nz_count[i - 1];
  model->sv_coef.assign(nr_class - 1, std::vector<double>(total_sv));
  {
    int p = 0;
    for (i = 0; i < nr_class; i++)
      for (int j = i + 1; j < nr_class; j++) {
        int si = start[i];
        int sj = start[j];
        int ci = count[i];
        int cj = count[j];
        int q = nz_start[i];
        int k;
        for (k = 0; k < ci; k++)
          if (nonzero[si + k]) model->sv_coef[j - 1][q++] = f[p].alpha[k];
        q = nz_start[j];
        for (k = 0; k < cj; k++)
          if (nonzero[sj + k]) model->sv_coef[i][q++] = f[p].alpha[ci + k];
        ++p;
      }
  }
  for (i = 0; i < n_pairs; i++) free(f[i].alpha);
  return model;
}

struct Fit {
  Model* model;
  int status;
};

}  // namespace

extern "C" {

// SVC(kernel="rbf", C, gamma, tol=eps, shrinking, cache_size,
// probability=True) on the float64 rows X (n, f) with class labels y
// (integers held as doubles), every sample weight 1: libsvm's svm_train
// after set_seed(random_seed).  Returns a handle for ce_svc_sizes /
// ce_svc_copy / ce_svc_free.
void* ce_svc_train(const double* X, int64_t n, int64_t f, const double* y,
                   double C, double gamma, double eps, int shrinking,
                   double cache_size, int64_t random_seed) {
  std::vector<Node> nodes(n);
  for (int64_t i = 0; i < n; ++i) nodes[i] = {(int)f, (int)i, X + i * f};
  std::vector<double> W(n, 1.0);
  Problem prob{(int)n, y, nodes.data(), W.data()};
  Param param{gamma, C, eps, cache_size, shrinking, 1, -1, 0, {0, 0},
              {0, 0}};

  // The shuffles of the pairs' probability fits, drawn as the sequential
  // svm_train draws them: set_seed(random_seed) first, then each pair's
  // shuffle from the generator as the previous pair left it (a pair whose
  // cross-validation trains a sub-model calls set_seed again).
  std::mt19937 mt_rand(std::mt19937::default_seed);
  if (random_seed >= 0) mt_rand.seed((unsigned)random_seed);
  int nr_class;
  std::vector<int> label, start, count, perm(n);
  svm_group_classes(&prob, &nr_class, label, start, count, perm.data());
  std::vector<PairPlan> plans;
  for (int i = 0; i < nr_class; i++)
    for (int j = i + 1; j < nr_class; j++) {
      const int l = count[i] + count[j];
      std::vector<int> pp(l);
      for (int k = 0; k < l; k++) pp[k] = k;
      for (int k = 0; k < l; k++) {
        int s = k + bounded_rand_int(mt_rand, l - k);
        swap_(pp[k], pp[s]);
      }
      // labels of the pair's rows: +1 for the first count[i], -1 after
      bool reseeded = false;
      for (int fold = 0; fold < 5 && !reseeded; fold++) {
        int begin = fold * l / 5, end = (fold + 1) * l / 5;
        int p_count = 0, n_count = 0;
        for (int k = 0; k < l; k++) {
          if (k >= begin && k < end) continue;
          if (pp[k] < count[i]) p_count++;
          else n_count++;
        }
        reseeded = p_count > 0 && n_count > 0;
      }
      if (reseeded && random_seed >= 0) mt_rand.seed((unsigned)random_seed);
      plans.push_back({pp});
    }

  Fit* fit = new Fit;
  fit->status = 0;
  fit->model = svm_train(&prob, &param, &fit->status, plans.data());
  return fit;
}

// nr_class, total support vectors and the solver's status (1: a solve hit
// max_iter).
void ce_svc_sizes(void* handle, int64_t* out) {
  Fit* fit = static_cast<Fit*>(handle);
  out[0] = fit->model->nr_class;
  out[1] = fit->model->l;
  out[2] = fit->status;
}

// support (row indices), n_support (nr_class), dual_coef
// ((nr_class-1) x l), intercept (-rho), probA, probB and n_iter
// (nr_class*(nr_class-1)/2 each).
void ce_svc_copy(void* handle, int64_t* support, int64_t* n_support,
                 double* dual_coef, double* intercept, double* probA,
                 double* probB, int64_t* n_iter) {
  const Model* m = static_cast<Fit*>(handle)->model;
  for (int i = 0; i < m->l; ++i) support[i] = m->sv_ind[i];
  for (int i = 0; i < m->nr_class; ++i) n_support[i] = m->nSV[i];
  for (int r = 0; r < m->nr_class - 1; ++r)
    for (int i = 0; i < m->l; ++i) dual_coef[r * m->l + i] = m->sv_coef[r][i];
  const int n_pairs = m->nr_class * (m->nr_class - 1) / 2;
  for (int p = 0; p < n_pairs; ++p) {
    intercept[p] = -m->rho[p];
    probA[p] = m->probA[p];
    probB[p] = m->probB[p];
    n_iter[p] = m->n_iter[p];
  }
}

void ce_svc_free(void* handle) {
  Fit* fit = static_cast<Fit*>(handle);
  delete fit->model;
  delete fit;
}

}  // extern "C"
