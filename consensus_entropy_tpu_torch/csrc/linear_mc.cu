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
// The (N, K, M, C) logits and probabilities never reach device memory.
//
// What bounds it on an H100 SXM (data-sheet peaks, 700 W): at the slice's
// shapes (N = 100,000, K = 4, F = 260, M = 16, C = 4) a launch must read
// N*K*F*4 = 416,000,000 B of features: 0.1244 ms at 3.35 TB/s.  The product
// is 2*N*K*F*M*C = 13.3 GFLOP; in float32 on the CUDA cores that alone is
// 0.199 ms (67 TFLOP/s), so a float32 design could never reach the bytes.
// Here the product runs on the tensor cores as 3xTF32: each value v splits
// into hi = rna_tf32(v) and lo = rna_tf32(v - hi), and
//     x.W ~= x_lo.W_hi + x_hi.W_lo + x_hi.W_hi
// in float32 accumulators, as accurate as the float32 product at the
// repo's rtol 1e-5 / atol 1e-6 gate (one TF32 product is not).  Three
// products are 40 GFLOP: 0.081 ms at 495 TFLOP/s, under the 0.1244 ms of
// bytes.  So the kernel is bound by bytes, and the design keeps the copy
// engine busy and reads the features once:
// - Persistent blocks, one per SM, walk the 128-song tiles in groups of
//   floor(64 / K) songs (one m64 row block; a song never straddles two).
//   W, split into hi and lo and transposed to (N_pad, F_pad) K-major in the
//   wgmma core-matrix layout, is written to shared memory once per block.
// - One producer warp feeds a ring of STAGES boxes (64 rows x 32 features,
//   128-byte swizzle) by TMA on mbarriers; the tensor map's zero fill
//   covers the feature tail and the ragged last tile.  A pool whose rows
//   are not 16-byte aligned (F % 4 != 0) is copied by the same warp with
//   cp.async into the same swizzled layout.
// - Two consumer warpgroups take the groups in turn (ping-pong): one runs
//   its main loop on the ring while the other is in its epilogue.  The main
//   loop reads a box's A fragment into registers, splits it there, releases
//   the stage and issues the chunk's 12 wgmma m64nNk8, keeping two chunks
//   in flight; the accumulators stay in registers over all of F.
// - Epilogue: for C and K in {1, 2, 4, 8} (the slice) straight from the
//   accumulators with fixed butterflies; otherwise logits are staged in
//   shared memory, one softmax per (row, member), frames summed in frame
//   order, members in member order.  A fixed order either way, no atomics.
// - Candidates: one warp runs n_cand passes of (max, lowest index) over the
//   tile's entropies; taken slots become NaN, which never compares greater
//   or equal, so each pass picks a new row.  Tiles write in tile order, so
//   a stable merge keeps "lowest global index wins".

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

using linear_mc_detail::wgmma_tf32;

constexpr int CONSUMERS = 2;                    // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int STAGES = 6;                       // boxes in the ring
constexpr int BOX_F = 32;                       // features per box: 128 B
constexpr int BOX_ROWS_MAX = 64;
constexpr int STAGE_BYTES = BOX_ROWS_MAX * BOX_F * 4;
constexpr int LOGIT_COLS = 32;                  // logits staged at a time
constexpr int LOGIT_STRIDE = LOGIT_COLS + 4;
constexpr int EPI_UNROLL = 4;                   // softmaxes in flight
constexpr int MAX_TILE = 128;
constexpr int MAX_CLASSES = 8;
constexpr int MAX_N = 256;                      // wgmma's widest N
constexpr int MAX_FRAMES = 64;                  // a song within one m64 block
constexpr size_t MAX_SMEM = 232448;             // 227 KB a block may opt in

// Features padded to whole boxes: every chunk runs the same four k8 steps,
// so no wgmma sits behind a branch (ptxas would serialize them all).
__host__ __device__ constexpr int pad_f(int n_feat) {
  return (n_feat + BOX_F - 1) / BOX_F * BOX_F;
}

// Everything the block keeps in shared memory, in bytes, with 1 KB of slack
// to align the swizzled stages.
size_t smem_bytes(int n_feat, int n_pad) {
  const size_t f_pad = pad_f(n_feat);
  return 1024 + (size_t)STAGES * STAGE_BYTES + 2 * (size_t)n_pad * f_pad * 4 +
         (size_t)CONSUMERS * 64 * LOGIT_STRIDE * 4 + (size_t)n_pad * 4 +
         2 * MAX_TILE * 4 + 2 * STAGES * 8;
}

int pad_n(int mc) {
  int n = 8;
  while (n < mc) n *= 2;
  return n;
}

struct Params {
  const float* x;
  const float* w;
  const float* b;
  const unsigned char* mask;
  float* ent;
  float* cand_v;
  long long* cand_i;
  long long n;
  int k_frames, n_feat, n_members, n_class, tile, n_cand;
  int spw;        // songs per box and group: floor(64 / K)
  int box_rows;   // spw * K
  int use_tma;
  int epilogue_in_registers;   // C and K in {1, 2, 4, 8}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins inside one PTX block (its labels are local to the block), so the
// compiler sees no divergent loop around the warpgroup's wgmma.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// Named barriers: 1 + wg within a warpgroup, 3 + tile parity for a tile's
// entropies, 5 + wg for the turns on the ring (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Byte offset of (row, col) in a box of 32-float rows under the 128-byte
// swizzle TMA applies: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// wgmma descriptor of a K-major operand without swizzle: 8-row x 16-byte
// core matrices, LBO between the two core matrices of a k8 step (K
// direction), SBO between 8-row groups (N direction).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// W[f, col] (f < F, col < M*C) -> hi and lo, in the core-matrix layout:
// step s = f / 8, group g = col / 8, half h = (f % 8) / 4, row r = col % 8,
// lane q = f % 4 at float ((s * (N/8) + g) * 2 + h) * 32 + r * 4 + q.
template <int N>
__device__ void stage_weights(const Params& p, float* w_hi, float* w_lo,
                              int f_pad) {
  const int mc = p.n_members * p.n_class;
  for (int i = threadIdx.x; i < f_pad * N; i += THREADS) {
    const int f = i / N, col = i % N;
    const float v = (f < p.n_feat && col < mc) ? p.w[(size_t)f * mc + col]
                                               : 0.f;
    const uint32_t hi = to_tf32(v);
    const uint32_t lo = to_tf32(v - __uint_as_float(hi));
    const int at = (((f >> 3) * (N / 8) + (col >> 3)) * 2 + ((f >> 2) & 1)) *
                       32 + (col & 7) * 4 + (f & 3);
    w_hi[at] = __uint_as_float(hi);
    w_lo[at] = __uint_as_float(lo);
  }
}

// One member's softmax over its C logits z (in place), with the bias b:
// shifted by the member's mean logit, not the row max, which is exact for
// the softmax and independent of the other members; at least one class
// sits at or above the mean, so the sum is >= 1.  expf, not __expf.
__device__ __forceinline__ void softmax_in_place(float* z, const float* b,
                                                 int C) {
  float v[MAX_CLASSES];
  float zsum = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_CLASSES; ++c) {
    if (c < C) {
      v[c] = z[c] + b[c];
      zsum += v[c];
    }
  }
  const float zmean = zsum / C;
  float esum = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_CLASSES; ++c) {
    if (c < C) {
      v[c] = expf(fminf(v[c] - zmean, 85.f));
      esum += v[c];
    }
  }
  const float inv = 1.f / esum;
#pragma unroll
  for (int c = 0; c < MAX_CLASSES; ++c)
    if (c < C) z[c] = v[c] * inv;
}

// Epilogue straight from the accumulators, for C in {1, 2, 4, 8} and K in
// {1, 2, 4, 8} (the slice's C = 4, K = 4).  In wgmma's m64nN layout a
// thread holds columns 8j + 2tq + {0, 1} of rows g and g + 8 of its warp's
// 16, so a member's C classes lie in the C / 2 lanes of one quad and a
// song's K frames in the lanes g, g + 1, ... of one row half.  Each sum is
// a fixed butterfly (every lane gets the same bits) or a fixed loop:
// classes, then frames, then members by column block j, then by lane.
// With C and K known at run time (CT = KT = 0) every butterfly runs its
// full length and adds 0 on the steps it does not need: a branch around a
// shuffle would keep the N / 4 independent softmaxes of a thread from
// interleaving, and the epilogue is bound by latency then.  With CT and KT
// compiled in, the steps not needed are not emitted.  The slice's
// (C, K) = (4, 4) (four emotion quadrants, bench.py's four frames per
// song) is compiled in: the kernel then takes 0.276-0.278 ms at configs[4]
// scale, against 0.314 ms with the run-time shape (H100 SXM at 700 W,
// chip_smoke.py run alternately with and without it; PERF.md, run G).
// Both give the same bits: a step that adds 0 leaves a finite sum as it is.
template <int N, int CT, int KT>
__device__ void epilogue_in_registers(const Params& p, const float* acc,
                                      const float* bias, long long tile0,
                                      int s0, int tile_valid, float* e_s,
                                      int warp, int lane) {
  const int C = CT ? CT : p.n_class, K = KT ? KT : p.k_frames;
  const int g = lane >> 2, tq = lane & 3;
  const int class_lanes = C >= 2 ? C / 2 : 1;   // lanes holding one member
  const float inv_c = 1.f / C;                  // exact: C is a power of 2
  const int c_shift = 31 - __clz(C);
  // Butterfly step: x plus its partner's x when `use`, else x (plus 0).
  auto bfly = [](float x, int off, bool use) {
    if (CT && KT) return use ? x + __shfl_xor_sync(0xffffffffu, x, off) : x;
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    return x + (use ? y : 0.f);
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cons0 = 0.f, cons1 = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float z0 = acc[4 * j + 2 * h] + bias[col];
      const float z1 = acc[4 * j + 2 * h + 1] + bias[col + 1];
      float p0 = 1.f, p1 = 1.f;   // C = 1: a one-class softmax is 1
      if (C >= 2) {
        float zsum = z0 + z1;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          zsum = bfly(zsum, off, off < class_lanes);
        const float zmean = zsum * inv_c;
        const float e0 = expf(fminf(z0 - zmean, 85.f));
        const float e1 = expf(fminf(z1 - zmean, 85.f));
        float esum = e0 + e1;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          esum = bfly(esum, off, off < class_lanes);
        // 1 / esum without the division's slow-path branch: the hardware
        // estimate and one Newton step, within an ulp (esum is in [1, 8e37]).
        float inv;
        asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(esum));
        inv = fmaf(inv, fmaf(-esum, inv, 1.f), inv);
        p0 = e0 * inv;
        p1 = e1 * inv;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        p0 = bfly(p0, off, off < 4 * K);
        p1 = bfly(p1, off, off < 4 * K);
      }
      // Padding columns past M*C hold softmaxes of zeros: leave them out.
      if ((col >> c_shift) < p.n_members) cons0 += p0;
      if (((col + 1) >> c_shift) < p.n_members) cons1 += p1;
    }
    if (C == 1) cons0 += cons1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      cons0 = bfly(cons0, off, off >= class_lanes);
      cons1 = bfly(cons1, off, off >= class_lanes);
    }
    // This lane holds classes (2tq) % C and (2tq + 1) % C of its song.
    float total = C == 1 ? cons0 : cons0 + cons1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      total = bfly(total, off, off < class_lanes);
    float ent = 0.f;
    if (C >= 2) {
      const float q0 = cons0 / total, q1 = cons1 / total;
      if (q0 > 0.f) ent += q0 * logf(q0);
      if (q1 > 0.f) ent += q1 * logf(q1);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        ent = bfly(ent, off, off < class_lanes);
    }
    const int song = (warp * 16 + 8 * h + g) / K;
    const int in_tile = s0 + song;
    if (tq == 0 && g % K == 0 && in_tile < tile_valid) {
      const float v = p.mask[tile0 + in_tile] ? -ent : -CUDART_INF_F;
      p.ent[tile0 + in_tile] = v;
      e_s[in_tile] = v;
    }
  }
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The producer warp: one box per (tile, song group, feature chunk) of the
// block's tiles, in order; an odd number of boxes per group, the last one
// past F when the count of chunks is even.  Groups alternate between the
// two warpgroups, so the ring keeps streaming while one of them is in its
// epilogue.
__device__ void produce(const Params& p, const CUtensorMap* map,
                        unsigned char* stages, uint64_t* full,
                        uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (p.n + p.tile - 1) / p.tile;
  const int n_boxes = ((p.n_feat + BOX_F - 1) / BOX_F) | 1;
  const long long n_rows = p.n * p.k_frames;
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long tile0 = t * p.tile;
    const int tile_valid = (int)min((long long)p.tile, p.n - tile0);
    for (int s0 = 0; s0 < tile_valid; s0 += p.spw) {
      const long long row0 = (tile0 + s0) * p.k_frames;
      for (int ch = 0; ch < n_boxes; ++ch) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* dst = stages + stage * STAGE_BYTES;
        if (p.use_tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[stage], p.box_rows * BOX_F * 4);
            tma_load_2d(dst, map, &full[stage], ch * BOX_F, (int)row0);
          }
        } else {
          for (int i = lane; i < p.box_rows * BOX_F; i += 32) {
            const int r = i / BOX_F, c = i % BOX_F;
            const long long row = row0 + r;
            const int col = ch * BOX_F + c;
            const bool ok = row < n_rows && col < p.n_feat;
            const float* src = ok ? p.x + row * p.n_feat + col : p.x;
            asm volatile(
                "cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                    smem_u32(dst + swz(r, c))),
                "l"(src), "r"(ok ? 4 : 0)
                : "memory");
          }
          asm volatile("cp.async.wait_all;" ::: "memory");
          __threadfence_block();
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

template <int N>
__device__ void consume(const Params& p, int wg, const unsigned char* stages,
                        uint64_t* full, uint64_t* empty, const float* w_hi,
                        const float* w_lo, float* my_logits,
                        const float* bias, float* e_s) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int C = p.n_class;
  const long long n_tiles = (p.n + p.tile - 1) / p.tile;
  const int n_chunks = (p.n_feat + BOX_F - 1) / BOX_F;
  const int n_boxes = n_chunks | 1;   // one, then pairs
  const int members_per_pass = LOGIT_COLS / C;
  const int my_row0 = warp * 16 + g;
  const uint32_t hi_addr = smem_u32(w_hi), lo_addr = smem_u32(w_lo);
  const uint32_t step_bytes = (N / 8) * 256;
  const int bar = 1 + wg;   // this warpgroup's named barrier
  uint32_t taken = 0;       // boxes the ring has delivered to either
  int group = 0;            // groups of this block so far
  int tile_count = 0;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tile_count) {
    const long long tile0 = t * p.tile;
    const int tile_valid = (int)min((long long)p.tile, p.n - tile0);
    float* es = e_s + (tile_count & 1) * MAX_TILE;
    for (int s0 = 0; s0 < tile_valid; s0 += p.spw, ++group) {
      if ((group & 1) != wg) {   // the other warpgroup's group
        taken += n_boxes;
        continue;
      }
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

      // A fragment of m64k8 TF32 for the four k8 steps of a chunk: per warp
      // rows g and g + 8 of its 16, columns tq and tq + 4 of each step,
      // split into hi and lo here.  The stage is released once it is read.
      auto load = [&](uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
        const int stage = taken % STAGES;
        mbar_wait(&full[stage], (taken / STAGES) & 1);
        ++taken;
        const unsigned char* box = stages + stage * STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = my_row0 + (e & 1) * 8;
            const int col = j * 8 + tq + (e >> 1) * 4;
            const float v =
                *reinterpret_cast<const float*>(box + swz(row, col));
            hi[j][e] = to_tf32(v);
            lo[j][e] = to_tf32(v - __uint_as_float(hi[j][e]));
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
      };
      // x.W over the chunk: x_lo.W_hi + x_hi.W_lo + x_hi.W_hi per step, as
      // one wgmma group, left in flight.
      auto issue = [&](uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], int ch) {
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t off = (ch * 4 + j) * step_bytes;
          wgmma_tf32<N>(acc, lo[j], desc_b(hi_addr + off));
          wgmma_tf32<N>(acc, hi[j], desc_b(lo_addr + off));
          wgmma_tf32<N>(acc, hi[j], desc_b(hi_addr + off));
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      };
      // The warpgroups take turns on the ring, in group order (a consumer
      // that skipped the other's boxes must not wait on a stage two phases
      // ahead of it), so each one's epilogue overlaps the other's main loop.
      // Chunks alternate between two sets of registers, so that one chunk's
      // split overlaps the other's products: a set is refilled only after
      // wgmma.wait_group 1 has retired the group that read it.  The first
      // chunk goes alone, the rest in pairs; an odd rest gets one more box,
      // wholly past F, which TMA fills with zeros (A = 0 adds nothing).  Any
      // branch around the loads or the wgmma would make ptxas serialize
      // every wgmma.
      if (group > 0) named_sync(5 + wg, CONSUMERS * 128);
      uint32_t a_hi[4][4], a_lo[4][4], b_hi[4][4], b_lo[4][4];
      load(a_hi, a_lo);
      issue(a_hi, a_lo, 0);
      for (int ch = 1; ch < n_boxes; ch += 2) {
        load(b_hi, b_lo);
        issue(b_hi, b_lo, ch);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        load(a_hi, a_lo);
        issue(a_hi, a_lo, min(ch + 1, n_chunks - 1));
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      }
      named_arrive(5 + (1 - wg), CONSUMERS * 128);   // the other's turn
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

      if (p.epilogue_in_registers) {
        if (C == 4 && p.k_frames == 4)
          epilogue_in_registers<N, 4, 4>(p, acc, bias, tile0, s0, tile_valid,
                                         es, warp, lane);
        else
          epilogue_in_registers<N, 0, 0>(p, acc, bias, tile0, s0, tile_valid,
                                         es, warp, lane);
        continue;
      }
      // Epilogue: this warpgroup's songs s0 + [0, spw), song s on rows
      // s * K + k.  Pass by pass over whole members of at most LOGIT_COLS
      // columns: the logits go to shared memory; one softmax per (row,
      // member) in place, EPI_UNROLL at a time for latency; one thread per
      // (song, member) sums its frames in frame order into the song's first
      // row; one thread per song adds the members in member order.
      const int rows = p.spw * p.k_frames;
      float cons[MAX_CLASSES];
#pragma unroll
      for (int c = 0; c < MAX_CLASSES; ++c) cons[c] = 0.f;
      for (int m0 = 0; m0 < p.n_members; m0 += members_per_pass) {
        const int mcount = min(members_per_pass, p.n_members - m0);
        const int col0 = m0 * C;
        named_sync(bar, 128);   // the previous pass is read
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const int col = (i / 4) * 8 + tq * 2 + (i & 1) - col0;
          const int row = warp * 16 + g + ((i >> 1) & 1) * 8;
          if (col >= 0 && col < mcount * C)
            my_logits[row * LOGIT_STRIDE + col] = acc[i];
        }
        named_sync(bar, 128);
        const int items = rows * mcount;
        for (int q0 = tid; q0 < items; q0 += 128 * EPI_UNROLL) {
#pragma unroll
          for (int u = 0; u < EPI_UNROLL; ++u) {
            const int q = q0 + u * 128;
            if (q < items)
              softmax_in_place(
                  my_logits + (q / mcount) * LOGIT_STRIDE + (q % mcount) * C,
                  bias + (m0 + q % mcount) * C, C);
          }
        }
        named_sync(bar, 128);
        for (int q = tid; q < p.spw * mcount; q += 128) {
          const int s = q / mcount, mm = q % mcount;
          float* first = my_logits + s * p.k_frames * LOGIT_STRIDE + mm * C;
          float sum[MAX_CLASSES];
#pragma unroll
          for (int c = 0; c < MAX_CLASSES; ++c) sum[c] = 0.f;
          for (int k = 0; k < p.k_frames; ++k) {
#pragma unroll
            for (int c = 0; c < MAX_CLASSES; ++c)
              if (c < C) sum[c] += first[k * LOGIT_STRIDE + c];
          }
          // Only this thread reads or writes these cells of the pass.
#pragma unroll
          for (int c = 0; c < MAX_CLASSES; ++c)
            if (c < C) first[c] = sum[c];
        }
        named_sync(bar, 128);
        if (tid < p.spw) {
          const float* row = my_logits + tid * p.k_frames * LOGIT_STRIDE;
          for (int mm = 0; mm < mcount; ++mm) {
#pragma unroll
            for (int c = 0; c < MAX_CLASSES; ++c)
              if (c < C) cons[c] += row[mm * C + c];
          }
        }
      }
      const int in_tile = s0 + tid;
      if (tid < p.spw && in_tile < tile_valid) {
        float total = 0.f;
#pragma unroll
        for (int c = 0; c < MAX_CLASSES; ++c)
          if (c < C) total += cons[c];
        float h = 0.f;
#pragma unroll
        for (int c = 0; c < MAX_CLASSES; ++c) {
          if (c < C) {
            const float pc = cons[c] / total;
            if (pc > 0.f) h += pc * logf(pc);
          }
        }
        const long long song = tile0 + in_tile;
        const float v = p.mask[song] ? -h : -CUDART_INF_F;
        p.ent[song] = v;
        es[in_tile] = v;
      }
    }

    // The warpgroup that took the tile's last group ranks the tile once the
    // other has arrived with its entropies.  Its warp 0 reads them into
    // registers at once (the other warpgroup cannot write this parity's
    // buffer again before this one takes its next turn).
    const int tile_bar = 3 + (tile_count & 1);
    if (((group - 1) & 1) != wg) {
      named_arrive(tile_bar, CONSUMERS * 128);
      continue;
    }
    named_sync(tile_bar, CONSUMERS * 128);
    if (p.n_cand > 0 && warp == 0) {
      // Lane l holds songs l + 32 i.  A pass takes the warp's (max, lowest
      // index) by butterfly, so every lane agrees, and the winner's slot
      // becomes NaN, which never compares greater or equal.
      const float gone = __int_as_float(0x7fc00000);
      float v[MAX_TILE / 32];
#pragma unroll
      for (int i = 0; i < MAX_TILE / 32; ++i)
        v[i] = lane + 32 * i < tile_valid ? es[lane + 32 * i] : gone;
      for (int j = 0; j < p.n_cand; ++j) {
        float bv = -CUDART_INF_F;
        int bi = INT_MAX;
#pragma unroll
        for (int i = 0; i < MAX_TILE / 32; ++i) {
          if (v[i] > bv || (v[i] == bv && lane + 32 * i < bi)) {
            bv = v[i];
            bi = lane + 32 * i;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          const long long slot = t * p.n_cand + j;
          p.cand_v[slot] = bv;   // -inf once the tile has no row left
          p.cand_i[slot] = tile0 + (bi == INT_MAX ? 0 : bi);
        }
#pragma unroll
        for (int i = 0; i < MAX_TILE / 32; ++i)
          if (lane + 32 * i == bi) v[i] = gone;
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
linear_mc_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages =
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const int f_pad = pad_f(p.n_feat);
  float* w_hi = reinterpret_cast<float*>(stages + STAGES * STAGE_BYTES);
  float* w_lo = w_hi + (size_t)N * f_pad;
  float* logits = w_lo + (size_t)N * f_pad;
  float* bias = logits + CONSUMERS * 64 * LOGIT_STRIDE;
  float* e_s = bias + N;
  uint64_t* full = reinterpret_cast<uint64_t*>(e_s + 2 * MAX_TILE);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  stage_weights<N>(p, w_hi, w_lo, f_pad);
  const int mc = p.n_members * p.n_class;
  for (int i = threadIdx.x; i < N; i += THREADS)
    bias[i] = i < mc ? p.b[i] : 0.f;
  // The weights are read by wgmma, through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // Warps 0-7 are the two consumer warpgroups, warp 8 the producer.  The
  // role is read from lane 0, so the compiler knows it is the same across
  // each warp: wgmma in a divergent path would be serialized.
  const int warp_id = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp_id >= CONSUMERS * 4) {
    produce(p, &map, stages, full, empty);
  } else {
    const int wg = warp_id / 4;
    consume<N>(p, wg, stages, full, empty, w_hi, w_lo,
               logits + wg * 64 * LOGIT_STRIDE, bias, e_s);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
    fn = reinterpret_cast<EncodeTiled>(ptr);
  return fn;
}

template <int N>
int launch(Params p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.n_feat, N);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (p.use_tma) {
    EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[2] = {(cuuint64_t)p.n_feat,
                                (cuuint64_t)(p.n * p.k_frames)};
    const cuuint64_t strides[1] = {(cuuint64_t)p.n_feat * 4};
    const cuuint32_t box[2] = {BOX_F, (cuuint32_t)p.box_rows};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<float*>(p.x), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      linear_mc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (p.n + p.tile - 1) / p.tile;
  const unsigned grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  linear_mc_kernel<N><<<grid, THREADS, smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int linear_mc_launch(const void* x, const void* w, const void* b,
                     const void* mask, void* ent, void* cand_v, void* cand_i,
                     long long n, int k_frames, int n_feat, int n_members,
                     int n_class, int tile, int n_cand, void* stream) {
  const long long mc = (long long)n_members * n_class;
  if (n <= 0 || k_frames <= 0 || k_frames > MAX_FRAMES || n_feat <= 0 ||
      n_members <= 0 || n_class <= 0 || n_class > MAX_CLASSES ||
      mc > MAX_N || tile <= 0 || tile > MAX_TILE || n_cand < 0 ||
      n * k_frames > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.mask = static_cast<const unsigned char*>(mask);
  p.ent = static_cast<float*>(ent);
  p.cand_v = static_cast<float*>(cand_v);
  p.cand_i = static_cast<long long*>(cand_i);
  p.n = n;
  p.k_frames = k_frames;
  p.n_feat = n_feat;
  p.n_members = n_members;
  p.n_class = n_class;
  p.tile = tile;
  p.n_cand = n_cand;
  p.spw = 64 / k_frames;
  p.box_rows = p.spw * k_frames;
  // TMA needs 16-byte rows and a 16-byte aligned base.
  p.use_tma = n_feat % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.epilogue_in_registers = (n_class & (n_class - 1)) == 0 &&
                            (k_frames & (k_frames - 1)) == 0 && k_frames <= 8;
  auto st = static_cast<cudaStream_t>(stream);
  switch (pad_n((int)mc)) {
    case 8: return launch<8>(p, st);
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
    case 128: return launch<128>(p, st);
    default: return launch<256>(p, st);
  }
}

const char* linear_mc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
