// The all-node InfoNCE denominator and its gradient, for NVIDIA Hopper
// (sm_90a).
//
//   lse[b] = log sum_j exp(q[b] . k[j] / tau)        b < B, j < n
//   dq[b]  = g[b] / tau * sum_j p[b, j] k[j]          p = exp(S / tau - lse)
//   dk[j]  = sum_b g[b] / tau * p[b, j] q[b]
//
// q (B x d) is the batch's rows of view 1 and k (n x d) every row of
// view 2, both f32 and L2-normalised by the caller
// (models/losses.py::info_nce; SGL: B = 2,048 against n = 29,859 users
// and 40,982 items, d = 64; NCL: the same, and the batch against its
// cluster centroids).  It replaces no TPU kernel: the JAX package
// leaves models/losses.py::info_nce and its _chunked_lse to XLA, which
// writes the B x n logits to memory, as torch.matmul and torch.logsumexp
// do, and reads them again some twenty times through the scaling, the
// softmax and their backward (0.58 GB a step at SGL's shapes).
//
// What bounds it on H100: operations.  The work is three products over
// the logits, 6 * B * n * d f32 operations a forward and backward (56
// GFLOP at SGL's shapes, 0.83 ms at 67 TFLOP/s), against inputs and
// outputs of a few MB.  The design keeps every logit on the chip:
//
//   1. nce_lse_kernel: a block holds a 128-row tile of q in shared
//      memory and streams its split's 128-row tiles of k through a
//      two-stage cp.async ring.  Each of its 256 threads forms an 8 x 8
//      patch of the 128 x 128 tile S = q k^T by f32 FMAs in registers,
//      scales it by log2(e) / tau and keeps a running max m and sum l
//      for each of its rows (exp2 of S - m).  It also writes the weights
//      exp2(S - m) to shared memory and accumulates o = sum_j exp2(S -
//      m) k[j] (accumulate_patch), so that the backward need not form
//      p @ k again.  It writes only a (row, split) partial: m, l, o.
//   2. nce_combine_kernel sums the splits of each row in split order:
//      lse, lse in log2 units for the backward, and o / l, the
//      softmax-weighted k whose multiple by g / tau is dq.
//   3. nce_grad_kernel: a block holds a 128-row tile of k and streams
//      the 128-row tiles of q of its row split.  It recomputes S (the
//      same FMAs in the same order, so the same values), forms
//      W = exp2(S - lse[b]) * g[b] / tau in shared memory and
//      accumulates dk for its tile in registers (accumulate_patch),
//      written once (or as one partial per row split).
//   4. nce_finish_kernel sums the row splits' dk partials in split
//      order and writes dq = g / tau * o.
//
// The splits are chosen by the caller (ops/nce.py) from B, n and the
// card's SM count, so that a small n (NCL's centroids) still fills the
// SMs.  Rows of d <= 64 floats run the instance D = 64, described here;
// rows of 64 < d <= 128 (embedding_size 96, 100, 128) the instance
// D = 128, whose tiles are twice as wide: one stage of the streamed
// tile, not two (three 128 x 132 tiles and the weights would pass the
// 227 KB of shared memory a block may hold), and the products with W
// split the columns between the block's halves, each half over every
// row, so a thread still holds an 8 x 8 patch.  d is a multiple of 4;
// columns d..D of the tiles are zeros.  A block holds 8 warps at
// 254-255 registers a thread, one block an SM.  Each thread's patches are 8 x 8, so that a 16-byte load from
// shared memory feeds 16 FMAs; the products with W split a tile's rows
// between the block's halves for it (an 8 x 4 patch over every row, as
// the first version had, was 1.5 % slower a pair).  Measured on the
// card (H100, SGL's two shapes, forward and backward): 2.10 ms for the
// first version, 2.07 with ex2.approx.ftz in place of exp2f, 1.98
// with the score loop unrolled whole, 1.93 with the split products; a
// 4 x 8 arrangement of a warp's threads in the backward gained < 1 %
// and was not kept.  Operands and sums are f32 throughout: no tensor
// cores (TF32 would keep 10 bits of mantissa), no atomics, every sum in
// a fixed order, so reruns and CUDA-graph replays repeat bit for bit;
// exp2 is ex2.approx.ftz (2 ulp, subnormal weights flushed to 0, below
// 1e-38 of a row's largest, which is 1).  Shared memory rows are
// padded (D + 4 floats for q and k, 144 for the weights)
// so that the patches' 16-byte loads and the weights' stores meet no
// bank conflict.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;      // the widest row the kernels hold (floats)
constexpr int kTile = 128;      // rows of a tile of q or k
constexpr int kThreads = 256;   // 16 x 16 threads, an 8 x 8 patch each
constexpr int kLdW = kTile + 16;  // a row of the weight tile

// the instance for rows of at most D floats (D = 64 or 128)
template <int D>
struct Shape {
  static constexpr int kLd = D + 4;  // a q or k row in shared memory
  static constexpr int kTileFloats = kTile * kLd;
  static constexpr int kStages = D == 64 ? 2 : 1;  // of the streamed tile
  // the held tile and the streamed stages, the weights, a tile's alphas
  static constexpr size_t kSmem =
      sizeof(float) *
      ((1 + kStages) * kTileFloats + kTile * kLdW + kTile);
};
constexpr double kLog2e = 1.4426950408889634;
constexpr float kLn2 = 0.69314718055994531f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes from g, or zeros where bytes is 0
__device__ __forceinline__ void cp_async16(void* s, const void* g,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [row0, row0 + kTile) of the (n_rows, d) matrix g into a tile;
// rows past n_rows read as zeros, columns past d are left as they are
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g,
                                          long long row0, long long n_rows,
                                          int d) {
  constexpr int kShift = D == 64 ? 4 : 5;  // 16-byte chunks of a row: 2^
  const int chunks = d >> 2;
#pragma unroll
  for (int u = 0; u < (kTile << kShift) / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c >> kShift, ch = c & ((1 << kShift) - 1);
    if (ch < chunks) {
      const long long row = row0 + r;
      const bool ok = row < n_rows;
      cp_async16(s + r * Shape<D>::kLd + ch * 4,
                 g + (ok ? row * d + ch * 4 : 0), ok ? 16 : 0);
    }
  }
}

// zeros in columns [d, D) of the held and streamed tiles, which no load
// writes
template <int D>
__device__ __forceinline__ void zero_pad_columns(float* s, int d) {
  const int pad = D - d;
  if (pad == 0) return;
  constexpr int kRows = (1 + Shape<D>::kStages) * kTile;
  for (int c = threadIdx.x; c < kRows * pad; c += kThreads)
    s[(c / pad) * Shape<D>::kLd + d + c % pad] = 0.f;
}

// columns [kk, kk + 4) of s[i][j] = a[ty + 16 i] . b[tx + 16 j]
template <int D>
__device__ __forceinline__ void score_step(const float* a, const float* b,
                                           int ty, int tx, int kk,
                                           float s[8][8]) {
  constexpr int kLd = Shape<D>::kLd;
  float4 av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) av[i] = lds4(a + (ty + 16 * i) * kLd + kk);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 bv = lds4(b + (tx + 16 * j) * kLd + kk);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i][j] = fmaf(av[i].x, bv.x, s[i][j]);
      s[i][j] = fmaf(av[i].y, bv.y, s[i][j]);
      s[i][j] = fmaf(av[i].z, bv.z, s[i][j]);
      s[i][j] = fmaf(av[i].w, bv.w, s[i][j]);
    }
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over D columns, in column order;
// the loop unrolled whole at D = 64, in fours at D = 128 (whole, its
// loads outran the registers and spilled)
template <int D>
__device__ __forceinline__ void score_patch(const float* a, const float* b,
                                            int ty, int tx, float s[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  if constexpr (D == 64) {
#pragma unroll
    for (int kk = 0; kk < D; kk += 4) score_step<D>(a, b, ty, tx, kk, s);
  } else {
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) score_step<D>(a, b, ty, tx, kk, s);
  }
}

// The products over a tile's rows r, acc[a][:] += sum_r w[a][r] b[r][:],
// each thread an 8 x 8 patch, rows ry + 16 i and columns c0 + 4 ex + e,
// c0 + 32 + 4 ex + e (e < 4), so that a thread reads 16 bytes of shared
// memory for every f32 FMA (an 8 x 4 patch over all 128 rows would read
// 24).  D = 64: the block's halves split the rows, half h takes rows r
// in [64 h, 64 h + 64), in row order, c0 = 0, and the halves' sums are
// added once, at the end (sum_halves).  D = 128: the halves split the
// columns, c0 = 64 h, each half over every row in row order.
template <int D>
struct AccLanes {
  int half, ry, ex;
  __device__ AccLanes()
      : half(threadIdx.x >> 7),
        ry(((threadIdx.x >> 5) & 3) * 4 + ((threadIdx.x >> 3) & 3)),
        ex(threadIdx.x & 7) {}
  __device__ int col0() const { return D == 64 ? 0 : 64 * half; }
  __device__ int col(int e) const {
    return col0() + (e >> 2) * 32 + 4 * ex + (e & 3);
  }
};

template <int D>
__device__ __forceinline__ void accumulate_patch(const float* w,
                                                 const float* b,
                                                 const AccLanes<D>& t,
                                                 float acc[8][8]) {
  constexpr int kLd = Shape<D>::kLd;
  constexpr int kRows = D == 64 ? kTile / 2 : kTile;  // a half's rows
  const int r0 = D == 64 ? t.half * (kTile / 2) : 0;
#pragma unroll 4
  for (int r = r0; r < r0 + kRows; r += 4) {
    float4 wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wv[i] = lds4(w + (t.ry + 16 * i) * kLdW + r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 b0 = lds4(b + (r + u) * kLd + t.col0() + 4 * t.ex);
      const float4 b1 = lds4(b + (r + u) * kLd + t.col0() + 32 + 4 * t.ex);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float wi = u == 0 ? wv[i].x
                         : u == 1 ? wv[i].y
                         : u == 2 ? wv[i].z
                                  : wv[i].w;
        acc[i][0] = fmaf(wi, b0.x, acc[i][0]);
        acc[i][1] = fmaf(wi, b0.y, acc[i][1]);
        acc[i][2] = fmaf(wi, b0.z, acc[i][2]);
        acc[i][3] = fmaf(wi, b0.w, acc[i][3]);
        acc[i][4] = fmaf(wi, b1.x, acc[i][4]);
        acc[i][5] = fmaf(wi, b1.y, acc[i][5]);
        acc[i][6] = fmaf(wi, b1.z, acc[i][6]);
        acc[i][7] = fmaf(wi, b1.w, acc[i][7]);
      }
    }
  }
}

// after the last tile (and a barrier), D = 64: the second half's
// patches into the first half's through shared memory at red (128 x
// kLd floats); afterwards the first half holds the sums.  D = 128: each
// half holds its own columns' sums already
template <int D>
__device__ __forceinline__ void sum_halves(float* red, const AccLanes<D>& t,
                                           float acc[8][8]) {
  if constexpr (D == 64) {
    constexpr int kLd = Shape<D>::kLd;
    if (t.half == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[(t.ry + 16 * i) * kLd + t.col(e)] = acc[i][e];
    }
    __syncthreads();
    if (t.half == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[i][e] += red[(t.ry + 16 * i) * kLd + t.col(e)];
    }
  }
}

// row ry + 16 i of the summed patches (D = 64: the first half's; D =
// 128: both halves') to out (rows of d floats from row0, n_rows of them)
template <int D>
__device__ __forceinline__ void store_patch(float* __restrict__ out,
                                            long long row0, long long n_rows,
                                            int d, const AccLanes<D>& t,
                                            const float acc[8][8]) {
  if (D == 64 && t.half != 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + t.ry + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = t.col(4 * h);
      if (c < d)
        *reinterpret_cast<float4*>(out + row * d + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// grid (splits, row tiles of q).  Partials at [split * B + row]: m (log2
// units), l; o at [(split * B + row) * d + col].
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
nce_lse_kernel(const float* __restrict__ q, const float* __restrict__ k,
               int B, int n, int d, float c, int tiles_per_split,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_o) {
  constexpr int kTileFloats = Shape<D>::kTileFloats;
  constexpr int kStages = Shape<D>::kStages;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;
  float* const ks = smem + kTileFloats;  // kStages stages
  float* const ws = smem + (1 + kStages) * kTileFloats;
  float* const alphas = ws + kTile * kLdW;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const AccLanes<D> lanes;
  const int split = blockIdx.x;
  const long long row0 = (long long)blockIdx.y * kTile;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);

  zero_pad_columns<D>(smem, d);
  load_tile<D>(qs, q, row0, B, d);
  load_tile<D>(ks, k, (long long)t0 * kTile, n, d);
  cp_async_commit();

  float m[8], l[8], o[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const float* kt = ks + ((t - t0) & (kStages - 1)) * kTileFloats;
    if (kStages == 2 && t + 1 < t1) {
      load_tile<D>(ks + ((t + 1 - t0) & 1) * kTileFloats, k,
                   (long long)(t + 1) * kTile, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][8];
    score_patch<D>(qs, kt, ty, tx, s);
    const int valid = n - t * kTile;  // the tile's real columns, >= 1
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
      if (valid >= kTile) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] *= c;
          mx = fmaxf(mx, s[i][j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = tx + 16 * j < valid ? s[i][j] * c : -INFINITY;
          s[i][j] = v;
          mx = fmaxf(mx, v);
        }
      }
      // the row's 16 threads are the lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - mn);  // 0 at the first tile
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ex2(s[i][j] - mn);
        sum += p;
        ws[(ty + 16 * i) * kLdW + tx + 16 * j] = p;
      }
      l[i] = fmaf(l[i], alpha, sum);
      if (tx == 0) alphas[ty + 16 * i] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = alphas[lanes.ry + 16 * i];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] *= alpha;
    }
    accumulate_patch<D>(ws, kt, lanes, o);
    __syncthreads();  // the stage, the weights and alphas are free again
    if (kStages == 1 && t + 1 < t1) {
      load_tile<D>(ks, k, (long long)(t + 1) * kTile, n, d);
      cp_async_commit();
    }
  }
  sum_halves<D>(ws, lanes, o);
  store_patch<D>(part_o + (long long)split * B * d, row0, B, d, lanes, o);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const long long row = row0 + ty + 16 * i;
    if (row >= B) continue;
    const long long at = (long long)split * B + row;
    if (tx == 0) {
      part_m[at] = m[i];
      part_l[at] = l[i];
    }
  }
}

// 16 threads a row, 16 rows a block: the splits in order
__global__ void __launch_bounds__(kThreads)
nce_combine_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_o, int B, int d,
                   int splits, float* __restrict__ lse,
                   float* __restrict__ lse2, float* __restrict__ o) {
  const long long row = (long long)blockIdx.x * 16 + (threadIdx.x >> 4);
  const int lane = threadIdx.x & 15;
  if (row >= B) return;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, part_m[s * (long long)B + row]);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long at = s * (long long)B + row;
    sum = fmaf(part_l[at], exp2f(part_m[at] - mx), sum);
  }
  if (lane == 0) {
    lse2[row] = mx + log2f(sum);
    lse[row] = fmaf(mx, kLn2, logf(sum));
  }
  const float inv = 1.f / sum;
  for (int col = 4 * lane; col < d; col += 64) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const long long at = s * (long long)B + row;
      const float w = exp2f(part_m[at] - mx) * inv;
      const float4 v =
          *reinterpret_cast<const float4*>(part_o + at * d + col);
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(o + row * d + col) = acc;
  }
}

// grid (tiles of k, row splits of q).  dk (or the row split's partial,
// at [split * n + row]) for the block's tile of k.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
nce_grad_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ lse2, const float* __restrict__ g,
                int B, int n, int d, float c, float inv_tau,
                int tiles_per_split, float* __restrict__ dk) {
  constexpr int kTileFloats = Shape<D>::kTileFloats;
  constexpr int kStages = Shape<D>::kStages;
  extern __shared__ __align__(16) float smem[];
  float* const kts = smem;
  float* const qs = smem + kTileFloats;  // kStages stages
  float* const ws = smem + (1 + kStages) * kTileFloats;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const AccLanes<D> lanes;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int b_tiles = (B + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, b_tiles);

  zero_pad_columns<D>(smem, d);
  load_tile<D>(kts, k, row0, n, d);
  load_tile<D>(qs, q, (long long)t0 * kTile, B, d);
  cp_async_commit();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const float* qt = qs + ((t - t0) & (kStages - 1)) * kTileFloats;
    if (kStages == 2 && t + 1 < t1) {
      load_tile<D>(qs + ((t + 1 - t0) & 1) * kTileFloats, q,
                   (long long)(t + 1) * kTile, B, d);
      cp_async_commit();
    }
    // the tile's rows of q: their lse (log2 units) and g / tau, 0 past B
    float ls[8], gs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = t * kTile + tx + 16 * j;
      ls[j] = b < B ? __ldg(lse2 + b) : 0.f;
      gs[j] = b < B ? __ldg(g + b) * inv_tau : 0.f;
    }
    if (kStages == 2 && t + 1 < t1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    float s[8][8];
    score_patch<D>(kts, qt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ws[(ty + 16 * i) * kLdW + tx + 16 * j] =
            ex2(fmaf(s[i][j], c, -ls[j])) * gs[j];
    __syncthreads();
    accumulate_patch<D>(ws, qt, lanes, acc);
    __syncthreads();
    if (kStages == 1 && t + 1 < t1) {
      load_tile<D>(qs, q, (long long)(t + 1) * kTile, B, d);
      cp_async_commit();
    }
  }
  sum_halves<D>(ws, lanes, acc);
  store_patch<D>(dk + (long long)split * n * d, row0, n, d, lanes, acc);
}

// 16 threads a row, 16 rows a block: rows [0, n_dk) sum the row splits'
// dk partials in split order; the next B rows are dq = g / tau * o
__global__ void __launch_bounds__(kThreads)
nce_finish_kernel(const float* __restrict__ part_dk, int splits, int n_dk,
                  const float* __restrict__ o, const float* __restrict__ g,
                  float inv_tau, int B, int d, float* __restrict__ dk,
                  float* __restrict__ dq) {
  const long long row = (long long)blockIdx.x * 16 + (threadIdx.x >> 4);
  const int lane = threadIdx.x & 15;
  if (row >= (long long)n_dk + B) return;
  if (row < n_dk) {
    for (int col = 4 * lane; col < d; col += 64) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < splits; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(
            part_dk + (s * (long long)n_dk + row) * d + col);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(dk + row * d + col) = acc;
    }
    return;
  }
  const long long b = row - n_dk;
  const float w = g[b] * inv_tau;
  for (int col = 4 * lane; col < d; col += 64) {
    const float4 v = *reinterpret_cast<const float4*>(o + b * d + col);
    *reinterpret_cast<float4*>(dq + b * d + col) =
        make_float4(w * v.x, w * v.y, w * v.z, w * v.w);
  }
}

// lets fn take `bytes` of dynamic shared memory (above the default 48
// KB) on the current device; set before every launch
int allow_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shape_ok(long long B, long long n, int d, double tau) {
  return B > 0 && n > 0 && B <= 0x7fffffffLL && n <= 0x7fffffffLL &&
         d > 0 && d <= kMaxD && d % 4 == 0 && tau > 0.0;
}

template <int D>
int forward_kernel(const float* q, const float* k, long long B, long long n,
                   int d, float c, int splits, int tiles_per_split,
                   float* pm, float* pl, float* po, cudaStream_t st) {
  constexpr size_t smem = Shape<D>::kSmem;
  const int err = allow_smem((const void*)nce_lse_kernel<D>, smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid((unsigned)splits, (unsigned)((B + kTile - 1) / kTile));
  nce_lse_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, (int)B, (int)n, d, c, tiles_per_split, pm, pl, po);
  return (int)cudaGetLastError();
}

template <int D>
int grad_kernel(const float* q, const float* k, const float* lse2,
                const float* g, long long B, long long n, int d, float c,
                float inv_tau, int splits, int tiles_per_split, float* out,
                cudaStream_t st) {
  constexpr size_t smem = Shape<D>::kSmem;
  const int err = allow_smem((const void*)nce_grad_kernel<D>, smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)splits);
  nce_grad_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, lse2, g, (int)B, (int)n, d, c, inv_tau, tiles_per_split, out);
  return (int)cudaGetLastError();
}

unsigned blocks16(long long rows) { return (unsigned)((rows + 15) / 16); }

}  // namespace

// The forward: lse (B,), lse2 (B,) and the softmax-weighted rows o (B,
// d).  part_m, part_l (splits, B) and
// part_o (splits, B, d) are the caller's scratch; splits *
// tiles_per_split covers the ceil(n / 128) tiles of k, each split at
// least one.  Every pointer 16-byte aligned, every array contiguous f32.
// Launches on `stream`; returns a cudaError_t.
extern "C" int nce_forward_launch(const void* q, const void* k, long long B,
                                  long long n, int d, double tau,
                                  int splits, int tiles_per_split,
                                  void* part_m, void* part_l, void* part_o,
                                  void* lse, void* lse2, void* o,
                                  void* stream) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (!shape_ok(B, n, d, tau) || splits <= 0 || tiles_per_split <= 0 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float c = (float)(kLog2e / tau);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* po = static_cast<float*>(part_o);
  const int err =
      d <= 64 ? forward_kernel<64>(qp, kp, B, n, d, c, splits,
                                   tiles_per_split, pm, pl, po, st)
              : forward_kernel<128>(qp, kp, B, n, d, c, splits,
                                    tiles_per_split, pm, pl, po, st);
  if (err != (int)cudaSuccess) return err;
  nce_combine_kernel<<<blocks16(B), kThreads, 0, st>>>(
      pm, pl, po, (int)B, d, splits, static_cast<float*>(lse),
      static_cast<float*>(lse2), static_cast<float*>(o));
  return (int)cudaGetLastError();
}

// The backward: dq (B, d) and dk (n, d) from g (B,), the forward's lse2
// and o.  With splits > 1 part_dk (splits, n, d) is the caller's
// scratch; with splits == 1 it may be null and dk is written directly.
// splits * tiles_per_split covers the ceil(B / 128) tiles of q, each
// split at least one.  Launches on `stream`; returns a cudaError_t.
extern "C" int nce_backward_launch(const void* q, const void* k,
                                   const void* lse2, const void* o,
                                   const void* g, long long B, long long n,
                                   int d, double tau, int splits,
                                   int tiles_per_split, void* part_dk,
                                   void* dk, void* dq, void* stream) {
  const long long b_tiles = (B + kTile - 1) / kTile;
  if (!shape_ok(B, n, d, tau) || splits <= 0 || tiles_per_split <= 0 ||
      (long long)splits * tiles_per_split < b_tiles ||
      (long long)(splits - 1) * tiles_per_split >= b_tiles ||
      (splits > 1 && part_dk == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float c = (float)(kLog2e / tau);
  const float inv_tau = (float)(1.0 / tau);
  float* out = static_cast<float*>(splits > 1 ? part_dk : dk);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* lp = static_cast<const float*>(lse2);
  const float* gp = static_cast<const float*>(g);
  const int err =
      d <= 64 ? grad_kernel<64>(qp, kp, lp, gp, B, n, d, c, inv_tau, splits,
                                tiles_per_split, out, st)
              : grad_kernel<128>(qp, kp, lp, gp, B, n, d, c, inv_tau,
                                 splits, tiles_per_split, out, st);
  if (err != (int)cudaSuccess) return err;
  const long long n_dk = splits > 1 ? n : 0;
  nce_finish_kernel<<<blocks16(n_dk + B), kThreads, 0, st>>>(
      static_cast<const float*>(part_dk), splits, (int)n_dk,
      static_cast<const float*>(o), static_cast<const float*>(g), inv_tau,
      (int)B, d, static_cast<float*>(dk), static_cast<float*>(dq));
  return (int)cudaGetLastError();
}
