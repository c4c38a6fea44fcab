// Fused consensus entropy over a committee of softmax-linear members, for
// NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// consensus_entropy_tpu_torch/kernels/linear_mc.py, which also holds the
// plain PyTorch version this kernel is checked against.
//
// Replaces the TPU kernel consensus_entropy_tpu/experimental/pallas_scoring.py
// ::_kernel (launched by _call_kernel through pl.pallas_call).  Same function:
// for every song n of the pool and every frame k,
//     z[m, c]  = x[n, k, :] . W[:, m*C + c] + b[m*C + c]
//     p[m, c]  = softmax_c(min(z[m, c] - mean_c z[m, :], 85))
// summed over frames and members, normalised, Shannon entropy in nats with
// 0 log 0 = 0, -inf where the pool mask is False; optionally each tile's
// top-n_cand (value, global index), lowest index first among ties.
// The (N, K, M, C) probabilities never reach device memory.
//
// What bounds it on an H100 SXM (data-sheet peaks, 700 W): at the slice's
// shapes (N = 100,000, K = 4, F = 260, M = 16, C = 4) a launch must read
// N*K*F*4 = 416,000,000 B of features (0.124 ms at 3.35 TB/s) and do
// 2*N*K*F*M*C = 13.3 GFLOP of float32 FMA plus 25.6 M expf (0.199 ms at
// 67 TFLOP/s on the CUDA cores).  So it sits near the line between memory
// and float32 compute, slightly on the compute side.  float32 throughout:
// no TF32, no bf16, no fast-math intrinsics, because the parity gate is
// rtol 1e-5 / atol 1e-6 and bf16 features fail it.
//
// Design (simple and right first; wgmma/TMA/TF32-aware work comes later):
// - A block owns TILE consecutive songs (a runtime argument) and walks
//   them in sub-tiles of THREADS / M songs.  Thread t computes song t / M,
//   member t % M, holding a KG-frame x C logit tile in registers, so each
//   member's softmax is thread-local.  Frames are walked in groups of KG.
// - The packed weights (F, M*C) sit in dynamic shared memory for the whole
//   block (66,560 B at the slice, over the 48 KB default, hence
//   cudaFuncSetAttribute); features are staged in FC-feature chunks, with
//   each warp reading one contiguous 128 B row segment and a padded row
//   stride in shared memory so the stores do not collide on banks.
// - Blocks run in no order and nothing carries between them: the member
//   sum is a fixed-order loop over a shared-memory table (deterministic,
//   no atomics), and the ragged last tile is masked here, not padded.
// - Candidates: one warp runs n_cand passes of (max, lowest index) over the
//   tile's entropies; taken slots become NaN, which never compares greater
//   or equal, so each pass picks a new row.  Tiles write in tile order, so
//   a stable merge keeps "lowest global index wins".

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int KG = 4;               // frames per register tile
constexpr int FC = 32;              // features per staged chunk
constexpr int XS_STRIDE = FC + 1;   // padded shared-memory row
constexpr int MAX_CLASSES = 8;

size_t smem_bytes(int n_feat, int n_members, int n_class, int tile) {
  const size_t mc = (size_t)n_members * n_class;
  const size_t sub = THREADS / n_members;
  return sizeof(float) *
         ((size_t)n_feat * mc + sub * KG * XS_STRIDE + sub * mc + tile);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
linear_mc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ ent, float* __restrict__ cand_v,
                 long long* __restrict__ cand_i, long long n, int k_frames,
                 int n_feat, int n_members, int tile, int n_cand) {
  extern __shared__ float smem[];
  const int mc = n_members * C;
  const int sub = THREADS / n_members;
  float* w_s = smem;                         // (F, M*C)
  float* x_s = w_s + n_feat * mc;            // (sub, KG, XS_STRIDE)
  float* p_s = x_s + sub * KG * XS_STRIDE;   // (sub, M*C)
  float* e_s = p_s + sub * mc;               // (tile,)

  const int t = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * tile;
  const int tile_valid = (int)min((long long)tile, n - tile0);

  for (int i = t; i < n_feat * mc; i += THREADS) w_s[i] = w[i];

  const int ls = t / n_members;    // song within the sub-tile
  const int mem = t % n_members;   // member
  float bias[C];
#pragma unroll
  for (int c = 0; c < C; ++c) bias[c] = ls < sub ? b[mem * C + c] : 0.f;

  for (int s_off = 0; s_off < tile_valid; s_off += sub) {
    const int nsub = min(sub, tile_valid - s_off);
    const long long song0 = tile0 + s_off;
    const bool worker = ls < nsub;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;

    for (int kg = 0; kg < k_frames; kg += KG) {
      const int kcount = min(KG, k_frames - kg);
      float logit[KG][C];
#pragma unroll
      for (int j = 0; j < KG; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) logit[j][c] = 0.f;

      for (int f0 = 0; f0 < n_feat; f0 += FC) {
        const int fcount = min(FC, n_feat - f0);
        __syncthreads();  // w_s stored; previous chunk fully read
        const int total = nsub * kcount * fcount;
        for (int i = t; i < total; i += THREADS) {
          const int ff = i % fcount;
          const int r = i / fcount;
          const int j = r % kcount;
          const int s = r / kcount;
          x_s[(s * KG + j) * XS_STRIDE + ff] =
              x[((song0 + s) * k_frames + kg + j) * n_feat + f0 + ff];
        }
        __syncthreads();
        if (worker) {
          const float* xrow = x_s + ls * KG * XS_STRIDE;
          for (int ff = 0; ff < fcount; ++ff) {
            const float* wrow = w_s + (f0 + ff) * mc + mem * C;
            float wv[C];
#pragma unroll
            for (int c = 0; c < C; ++c) wv[c] = wrow[c];
#pragma unroll
            for (int j = 0; j < KG; ++j) {
              if (j < kcount) {
                const float xv = xrow[j * XS_STRIDE + ff];
#pragma unroll
                for (int c = 0; c < C; ++c)
                  logit[j][c] = fmaf(xv, wv[c], logit[j][c]);
              }
            }
          }
        }
      }

      if (worker) {
#pragma unroll
        for (int j = 0; j < KG; ++j) {
          if (j < kcount) {
            float z[C];
            float zsum = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              z[c] = logit[j][c] + bias[c];
              zsum += z[c];
            }
            // Shift by this member's mean logit, not the row max: exact for
            // the softmax and independent of the other members.  At least
            // one class sits at or above the mean, so the sum is >= 1.
            const float zmean = zsum / C;
            float e[C];
            float esum = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              e[c] = expf(fminf(z[c] - zmean, 85.f));
              esum += e[c];
            }
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] += e[c] / esum;
          }
        }
      }
    }

    if (worker) {
#pragma unroll
      for (int c = 0; c < C; ++c) p_s[ls * mc + mem * C + c] = acc[c];
    }
    __syncthreads();
    if (t < nsub) {
      float cons[C];
      float total = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) cons[c] = 0.f;
      for (int m = 0; m < n_members; ++m) {
#pragma unroll
        for (int c = 0; c < C; ++c) cons[c] += p_s[t * mc + m * C + c];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) total += cons[c];
      float h = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = cons[c] / total;
        if (p > 0.f) h += p * logf(p);
      }
      const long long song = song0 + t;
      const float v = mask[song] ? -h : -CUDART_INF_F;
      ent[song] = v;
      e_s[s_off + t] = v;
    }
    // The next sub-tile's first __syncthreads orders these p_s reads
    // before its p_s writes.
  }

  if (n_cand == 0) return;
  __syncthreads();
  if (t < 32) {
    const float taken = __int_as_float(0x7fc00000);   // NaN
    for (int j = 0; j < n_cand; ++j) {
      float bv = -CUDART_INF_F;
      int bi = INT_MAX;
      for (int s = t; s < tile_valid; s += 32) {
        const float v = e_s[s];
        if (v > bv || (v == bv && s < bi)) {
          bv = v;
          bi = s;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (t == 0) {
        const long long slot = (long long)blockIdx.x * n_cand + j;
        cand_v[slot] = bv;   // -inf once the tile has no row left
        cand_i[slot] = tile0 + (bi == INT_MAX ? 0 : bi);
        if (bi != INT_MAX) e_s[bi] = taken;
      }
      __syncwarp();
    }
  }
}

template <int C>
int launch(const float* x, const float* w, const float* b,
           const unsigned char* mask, float* ent, float* cand_v,
           long long* cand_i, long long n, int k_frames, int n_feat,
           int n_members, int tile, int n_cand, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_feat, n_members, C, tile);
  cudaError_t err = cudaFuncSetAttribute(
      linear_mc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (n + tile - 1) / tile;
  linear_mc_kernel<C><<<(unsigned)grid, THREADS, smem, stream>>>(
      x, w, b, mask, ent, cand_v, cand_i, n, k_frames, n_feat, n_members,
      tile, n_cand);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int linear_mc_launch(const void* x, const void* w, const void* b,
                     const void* mask, void* ent, void* cand_v, void* cand_i,
                     long long n, int k_frames, int n_feat, int n_members,
                     int n_class, int tile, int n_cand, void* stream) {
  if (n <= 0 || k_frames <= 0 || n_feat <= 0 || n_members <= 0 ||
      n_members > THREADS || tile <= 0 || n_cand < 0 ||
      (long long)(n + tile - 1) / tile > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* ef = static_cast<float*>(ent);
  auto* cv = static_cast<float*>(cand_v);
  auto* ci = static_cast<long long*>(cand_i);
  auto st = static_cast<cudaStream_t>(stream);
#define LINEAR_MC_CASE(C)                                                   \
  case C:                                                                   \
    return launch<C>(xf, wf, bf, mk, ef, cv, ci, n, k_frames, n_feat,       \
                     n_members, tile, n_cand, st);
  switch (n_class) {
    LINEAR_MC_CASE(1)
    LINEAR_MC_CASE(2)
    LINEAR_MC_CASE(3)
    LINEAR_MC_CASE(4)
    LINEAR_MC_CASE(5)
    LINEAR_MC_CASE(6)
    LINEAR_MC_CASE(7)
    LINEAR_MC_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LINEAR_MC_CASE
}

int linear_mc_max_classes() { return MAX_CLASSES; }

const char* linear_mc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
