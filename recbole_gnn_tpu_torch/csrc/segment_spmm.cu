// Segment SpMM over dst-sorted edges, for NVIDIA Hopper (sm_90a).
//
//   out[r, :] = sum_{e in [rowptr[r], rowptr[r+1])} w[e] * x[src[e], :]
//
// Replaces recbole_gnn_tpu/ops/pallas_spmm.py::_spmm_kernel (the
// streaming one-hot-MXU Pallas kernel) on the LightGCN propagation
// path, forward and backward: the backward of the SpMM is the same
// kernel over the graph's reverse CSR (rows = the original sources),
// as recbole_gnn_tpu/ops/spmm.py::_spmm_core_bwd runs the Pallas
// kernel over rev_src/rev_dst/rev_block_ptr; the wrapper
// segment_spmm_transpose launches it that way.  The TPU kernel
// materialised a (segment, D) message stream in HBM, scanned it in
// <= 2^20-edge segments and reduced each chunk with a one-hot matrix
// product; none of that is needed here: this kernel gathers x[src]
// itself.
//
// What bounds it on H100: memory.  Per edge it reads 8 bytes of index
// and weight and one D-float row of x, for 2*D flops: 2 flops per 4
// gathered bytes, far below the card's fp32 balance point.  Tensor
// cores do not fit: the TPU's one-hot MXU product multiplies the flops
// by the block height and still moves the same bytes, so it would only
// add work to a kernel that waits on memory.  At the LightGCN slice
// shape the 18 MB x table stays in the 50 MB L2, so the DRAM traffic
// the work needs is indices + weights + one read of x + one write of
// out; the E*D*4 bytes of row gathers (436 MB there) are served by L2
// and set the practical floor.  The design keeps every byte it moves
// useful: 8- or 16-byte vector loads of whole x rows, each share's
// indices staged once into shared memory, one store per output element.
//
// Schedule: equal edge shares, not rows (ops/segment_spmm.py's
// share_schedule is the same arithmetic in torch, and the tests hold
// it against a per-edge lookup).  The edge list is cut into shares of
// T consecutive edges (share s = [s*T, (s+1)*T) within [rowptr[0],
// rowptr[n_rows])), each walked by one lane group of L lanes (L*VEC
// columns at a time; D wider than 32*VEC takes several passes), so a
// hub row of any length is spread over every share it touches and no
// launch waits on one row.  A block of kGroups groups stages its
// kGroups*T edges' src, w and dst into shared memory with cp.async
// while each group binary-searches rowptr for its first row; then the
// group walks its share in edge order with kUnroll row gathers in
// flight, keeping a running sum of the current row and flushing it
// where dst changes.  A row that lies in one share has that share as
// its one owner, which writes it.  A row that crosses a share boundary
// ("split": rowptr[r]/T != (rowptr[r+1]-1)/T) can only be a share's
// first or last row; its partial sums go to the share's carry slot 0
// (its first row) or 1 (its last row, if another) in a workspace of
// n_shares x 2 x D floats that the wrapper allocates.  A second kernel,
// launched right after on the same stream, visits every row once: an
// empty row is written as 0, a split row as the sum of its carries in
// share order, an owned row is left alone.  No value is added
// atomically: every sum has a fixed order and reruns repeat bit for
// bit.
//
// Hopper features: cp.async stages the share's indices, so index loads
// leave the gather chain.  The share is staged in one go, not in a
// double-buffered ring: a block walks its kGroups shares once, so
// there is nothing to overlap a second buffer with.  TMA's 1-D bulk
// copy would save only the ~3*T/L copy instructions per thread and
// needs 16-byte sizes; clusters and wgmma have no work here.  A
// programmatic dependent launch of the carry pass was tried: it hid
// little of the gap between the passes and made the profiler count its
// wait as busy time, so the two passes are plain launches.
//
// Limits of this design: (1) the carry pass reads the row pointers of
// every row, though only the split and empty ones have work; (2) a row
// spanning k shares is summed by one lane group, in k/16 + 4 rounds of
// loads at most (k = 52 for the slice's hub row at T = 256), and a
// group sums its up-to-8 rows one after another, so the carry pass
// takes longer on a skewed graph than on a uniform one of the same
// size; (3) dst is read (4 bytes per edge) to find row changes inside
// a share, on top of what the bound counts.
//
// Precision modes (pallas_spmm_precision; the TPU kernel's `mode`,
// pallas_spmm.py:275-288 and the hi/lo packing at :381-430).  A mode
// changes only how an edge's term is formed from w and the x row; the
// schedule, the carries and the bytes moved are the same:
//   0 f32    (f32x2) the exact term w*x, summed in f32;
//   1 bf16   the term rounded to bf16 (nearest even) after an f32
//            product, bf16(w*x), summed in f32;
//   2 packed x split into a truncated bf16 hi plane and a rounded bf16
//            lo plane, lo = bf16(x - hi); per edge m = (hi + lo)*w in
//            f32, split again into mh = trunc(m) and ml = bf16(m - mh);
//            the mh and ml terms are summed apart in f32 and added
//            where a row's (or a share's part of a row's) sum is
//            written, so a split row's carries hold mh + ml sums.
//
// The packed table.  The x side of a packed term depends on the row
// only, and a row is gathered E/N times (24 at the LightGCN slice
// shape), so it is formed once per call, as the TPU kernel's wrapper
// packs x once (_hi_lo_bits, pallas_spmm.py:385-388): pack_kernel
// writes x~ = hi + lo for every element of an f32 x into a workspace of
// x's shape, and the share pass gathers x~ where it gathered x.  The
// sum is exact in f32 (each part has at most 8 significant bits and lo
// lies below hi's last bit), so a term is bit for bit what the split per
// gathered element gave: one product, one truncation, one subtraction,
// half a paired rounding and two adds.  bf16 and packed round in pairs
// (__floats2bfloat162_rn, one conversion for two values, to nearest
// even as one at a time); bf16 on a bf16 x multiplies in pairs of bf16
// values (__hmul2).  Every instance keeps the bound on threads alone
// and ptxas's own registers (the f32x2 instance's 64, four 256-thread
// blocks on an SM at D = 64; packed on an f32 x 78, three): holding
// packed to 64 spilled 40 bytes a thread for 1.2 % (PERF.md), and
// rolling each piece's next gather in as soon as its term was added
// ran slower in every mode.
//
// bf16 x (activation_dtype: bfloat16): the kernel reads the bf16 rows
// itself (rows.cuh: 16-byte loads of 8 values where the row allows; no
// f32 copy of x is made) and writes an f32 output, as the TPU kernel
// does whatever x's type.  The terms as _pallas_spmm_jit forms them from
// a bf16 x: f32x2 and bf16 take the weight rounded to bf16
// (w.astype(x.dtype)); f32x2 adds the product of the two bf16 values,
// exact in f32 (two 8-bit significands make at most 16), and bf16 adds
// that product rounded to bf16; packed casts x to f32 (hi = x, lo = 0)
// and multiplies by the f32 weight, then splits m as above.  So a bf16
// x needs no pack: the share pass reads it as it is, x~ = x.  (Where x
// is -0 the split makes x~ +0, and a term may be a zero of the other
// sign, which no f32 sum from +0 can show; where x is infinite the split
// makes x~ NaN and this reads x~ = inf, whose term's lo part, bf16(inf -
// inf), is NaN all the same, and so is the row's output.)  The transpose
// gets an f32 cotangent (the forward's output type), packs it and runs
// the f32 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rows.cuh"

namespace {

constexpr int kGroups = 16;       // shares (lane groups) per block
constexpr int kUnroll = 8;        // row gathers in flight per lane group
constexpr int kFixThreads = 256;  // threads per block of the carry pass
constexpr int kCarryRows = 8;     // rows per lane group of the carry pass
constexpr int kPackThreads = 256; // threads per block of the pack pass
constexpr int kMaxSmem = 232448;  // what a block may use on H100
constexpr unsigned kFull = 0xffffffffu;
constexpr int kF32 = 0, kBf16 = 1, kPacked = 2;  // precision modes

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_trunc(float v) {
  return __int_as_float(__float_as_int(v) & 0xffff0000);
}

// the packed value of one f32 element: hi + lo, hi = trunc(v), lo =
// bf16(v - hi); exact in f32
__device__ __forceinline__ float pack1(float v) {
  const float h = bf16_trunc(v);
  return __fadd_rn(h, bf16_rn(__fsub_rn(v, h)));
}

// acc (and, in packed mode, lo) += the term of weight wt on the x piece
// v (x's element type T: the packed table x~ in packed mode, or a bf16 x
// as it is; a bf16 x's weight is rounded to bf16 but in packed mode).
// The bf16 roundings go in pairs.  A bf16 x in bf16 mode: the term
// bf16(bf16(w) * x), a product of two bf16 values, taken by the bf16
// multiply (__hmul2, round to nearest even), which gives the same bits as
// the f32 product rounded once (two 8-bit significands make at most 16,
// exact in f32).
template <int MODE, typename T, int VEC>
__device__ __forceinline__ void add_term(float* acc, float* lo, float wt,
                                         const rows::Piece<T, VEC>& v) {
  if constexpr (sizeof(T) == 2 && MODE == kBf16 && VEC > 1) {
    const __nv_bfloat162 w2 = __float2bfloat162_rn(wt);
#pragma unroll
    for (int k = 0; k < VEC; k += 2) {
      const __nv_bfloat162 m2 =
          *reinterpret_cast<const __nv_bfloat162*>(&v.r.w[k >> 1]);
      const float2 q = __bfloat1622float2(__hmul2(w2, m2));
      acc[k] += q.x;
      acc[k + 1] += q.y;
    }
    return;
  }
  if constexpr (sizeof(T) == 2 && MODE != kPacked) wt = bf16_rn(wt);
  if constexpr (MODE == kF32) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += wt * v.get(k);
  } else {
    // r: what is rounded to bf16 and added to sum: the product (bf16),
    // or what its truncation leaves (packed, whose truncation goes to acc)
    float r[VEC];
    float* const sum = MODE == kPacked ? lo : acc;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float m = __fmul_rn(v.get(k), wt);
      if constexpr (MODE == kPacked) {
        const float mh = bf16_trunc(m);
        acc[k] += mh;
        r[k] = __fsub_rn(m, mh);
      } else {
        r[k] = m;
      }
    }
    if constexpr (VEC == 1) {
      sum[0] += bf16_rn(r[0]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; k += 2) {
        const float2 q =
            __bfloat1622float2(__floats2bfloat162_rn(r[k], r[k + 1]));
        sum[k] += q.x;
        sum[k + 1] += q.y;
      }
    }
  }
}

// store a row's sum: acc, plus the lo plane in packed mode
template <int MODE, int VEC>
__device__ __forceinline__ void store_sum(float* p, const float* acc,
                                          const float* lo) {
  if constexpr (MODE == kPacked) {
    float s[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = acc[k] + lo[k];
    rows::store_f32<float, VEC>(p, s);
  } else {
    rows::store_f32<float, VEC>(p, acc);
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem_src));
}
__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem_src));
}

// copy n 4-byte words into shared memory: 16-byte pieces where both
// sides are 16-byte aligned (aligned16), single words for the rest
__device__ __forceinline__ void stage_words(uint32_t* s, const uint32_t* g,
                                            int n, bool aligned16) {
  const int n4 = aligned16 ? n / 4 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    cp_async16(s + 4 * i, g + 4 * i);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(s + i, g + i);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// row r's edges (clamped to the edge list) touch more than one share
__device__ __forceinline__ bool row_split(const int64_t* rowptr, int64_t r,
                                          int64_t t, int64_t n_edges) {
  const int64_t b0 = min64(rowptr[r], n_edges);
  const int64_t b1 = min64(rowptr[r + 1], n_edges);
  return b1 > b0 && b0 / t != (b1 - 1) / t;
}

// T (float or __nv_bfloat16) is deduced from x at the launch
template <int VEC, int MODE, typename T>
__global__ void __launch_bounds__(kGroups * 32)
share_sum_kernel(const T* __restrict__ x,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ w,
                 const int32_t* __restrict__ dst,
                 const int64_t* __restrict__ rowptr,
                 float* __restrict__ out, float* __restrict__ carry,
                 int64_t n_rows, int64_t n_edges, int d, int t, int L,
                 int aligned16) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int span = kGroups * t;  // edges a block stages; a multiple of 4
  const int32_t* s_src = reinterpret_cast<const int32_t*>(smem);
  const float* s_w = reinterpret_cast<const float*>(smem + span);
  const int32_t* s_dst = reinterpret_cast<const int32_t*>(smem + 2 * span);
  const int64_t blk_a = (int64_t)blockIdx.x * span;
  const int blk_n = (int)min64(span, n_edges - blk_a);
  stage_words(smem, reinterpret_cast<const uint32_t*>(src + blk_a), blk_n,
              aligned16);
  stage_words(smem + span, reinterpret_cast<const uint32_t*>(w + blk_a),
              blk_n, aligned16);
  stage_words(smem + 2 * span,
              reinterpret_cast<const uint32_t*>(dst + blk_a), blk_n,
              aligned16);
  asm volatile("cp.async.commit_group;\n" ::);

  // while the copies fly: this group's share and its first row, the
  // last r with rowptr[r] <= a (rowptr[n_rows] > a bounds the search)
  const int group = threadIdx.x / L;
  const int sub = threadIdx.x % L;
  const int64_t s = (int64_t)blockIdx.x * kGroups + group;
  const int64_t lo = min64(rowptr[0], n_edges);
  const int64_t hi = min64(rowptr[n_rows], n_edges);
  const int64_t a = max64(s * t, lo);
  const int64_t b = min64((s + 1) * t, hi);
  int64_t first = 0;
  bool first_split = false;
  if (a < b) {
    int64_t r0 = 0, r1 = n_rows;
    while (r1 - r0 > 1) {
      const int64_t mid = (r0 + r1) >> 1;
      if (rowptr[mid] <= a) r0 = mid; else r1 = mid;
    }
    first = r0;
    first_split = row_split(rowptr, first, t, n_edges);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (a >= b) return;  // group-uniform, after the block's only barrier

  const int64_t last = s_dst[b - 1 - blk_a];
  const bool last_split =
      last == first ? first_split : row_split(rowptr, last, t, n_edges);
  float* const slot0 = carry + (s * 2) * (int64_t)d;
  float* const slot1 = slot0 + d;

  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int col = c0 + sub * VEC;
    const bool active = col < d;  // d % VEC == 0: the whole vector is in
    int64_t cur = first;
    float acc[VEC], lo[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = lo[k] = 0.f;
    for (int64_t e0 = a; e0 < b; e0 += kUnroll) {
      const int i0 = (int)(e0 - blk_a);
      const int n_here = (int)min64(kUnroll, b - e0);
      rows::Piece<T, VEC> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && u < n_here) {
          v[u].ldg(x + (int64_t)s_src[i0 + u] * d + col);
        } else {
          v[u].zero();
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < n_here) {
          const int64_t r = s_dst[i0 + u];
          if (r != cur) {  // group-uniform: row cur is complete
            float* o = cur == first && first_split ? slot0
                                                   : out + cur * d;
            if (active && (uint64_t)cur < (uint64_t)n_rows)
              store_sum<MODE, VEC>(o + col, acc, lo);
            cur = r;
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = lo[k] = 0.f;
          }
          add_term<MODE>(acc, lo, s_w[i0 + u], v[u]);
        }
      }
    }
    // the share's last row (the first one too when it has one row)
    float* o;
    if (cur == first)
      o = first_split ? slot0 : out + cur * d;
    else
      o = last_split ? slot1 : out + cur * d;
    if (active && (uint64_t)cur < (uint64_t)n_rows)
      store_sum<MODE, VEC>(o + col, acc, lo);
  }
}

// acc += the N carry slots at c, c + 2d, ...: N loads issued together,
// added in order
template <int VEC, int N>
__device__ __forceinline__ void add_carries(float* acc, const float* c,
                                            int d) {
  rows::Piece<float, VEC> v[N];
#pragma unroll
  for (int u = 0; u < N; ++u) v[u].ldg(c + u * 2 * (int64_t)d);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] += v[u].get(q);
}

// the sum of a split row's carries, in share order: its first share
// s0's slot `slot`, then slot 0 of shares s0+1..s1 (batches of 16 (8
// for 8-wide pieces), 8, 4, 2, 1 loads issued together); nothing for an
// empty row (s1 < s0)
template <int VEC>
__device__ __forceinline__ void sum_carries(float* acc, const float* carry,
                                            int64_t s0, int64_t s1, int slot,
                                            int d, int col) {
  constexpr int kBig = VEC > 4 ? 8 : 16;
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  if (s1 < s0) return;
  rows::load_f32<float, VEC>(acc, carry + (s0 * 2 + slot) * (int64_t)d + col);
  const int64_t step = 2 * (int64_t)d;
  const float* c = carry + (s0 + 1) * step + col;
  int64_t left = s1 - s0;
  for (; left >= kBig; left -= kBig, c += kBig * step)
    add_carries<VEC, kBig>(acc, c, d);
  if (left & 8) { add_carries<VEC, 8>(acc, c, d); c += 8 * step; }
  if (left & 4) { add_carries<VEC, 4>(acc, c, d); c += 4 * step; }
  if (left & 2) { add_carries<VEC, 2>(acc, c, d); c += 2 * step; }
  if (left & 1) add_carries<VEC, 1>(acc, c, d);
}

// each row once: empty -> 0; split -> sum_carries; owned -> already
// written by share_sum_kernel.  A lane group of L lanes takes R =
// min(L, kCarryRows) consecutive rows: its first R lanes read one row's
// pointers each, the group ballots the rows with work and sums them one
// after another.  Groups share nothing, so a group with a long row
// holds up no other group.
template <int VEC>
__global__ void __launch_bounds__(kFixThreads)
carry_sum_kernel(const int64_t* __restrict__ rowptr,
                 const float* __restrict__ carry, float* __restrict__ out,
                 int64_t n_rows, int64_t n_edges, int d, int t, int L) {
  const int lane = threadIdx.x & 31;
  const int group = lane / L;
  const int sub = lane % L;
  const int R = L < kCarryRows ? L : kCarryRows;
  const int64_t base =
      ((int64_t)blockIdx.x * (kFixThreads / L) + threadIdx.x / L) * R;
  if (base >= n_rows) return;  // group-uniform
  const unsigned gmask = L == 32 ? kFull : ((1u << L) - 1u) << (group * L);
  long long b0 = 0, b1 = 0;
  bool work = false;
  if (sub < R && base + sub < n_rows) {
    b0 = min64(rowptr[base + sub], n_edges);
    b1 = min64(rowptr[base + sub + 1], n_edges);
    work = b1 <= b0 || b0 / t != (b1 - 1) / t;  // empty or split
  }
  unsigned todo = __ballot_sync(gmask, work) >> (group * L);
  const int64_t lo = min64(rowptr[0], n_edges);
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t r0 = __shfl_sync(gmask, b0, group * L + j);
    const int64_t r1 = __shfl_sync(gmask, b1, group * L + j);
    int64_t s0 = 0, s1 = -1;  // no carries: an empty row
    int slot = 0;
    if (r1 > r0) {
      s0 = r0 / t;
      s1 = (r1 - 1) / t;
      slot = r0 == max64(s0 * t, lo) ? 0 : 1;
    }
    for (int c0 = 0; c0 < d; c0 += L * VEC) {
      const int col = c0 + sub * VEC;
      if (col >= d) break;
      float acc[VEC];
      sum_carries<VEC>(acc, carry, s0, s1, slot, d, col);
      rows::store_f32<float, VEC>(out + (base + j) * (int64_t)d + col, acc);
    }
  }
}

// the packed table of an f32 x: xp[i] = pack1(x[i]) for its n values,
// four at a time where both are 16-byte aligned (vec4)
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ x, float* __restrict__ xp, int64_t n,
            int vec4) {
  const int64_t stride = (int64_t)gridDim.x * kPackThreads;
  const int64_t i = (int64_t)blockIdx.x * kPackThreads + threadIdx.x;
  const int64_t n4 = vec4 ? n / 4 : 0;
  for (int64_t j = i; j < n4; j += stride) {
    float4 v = __ldg(reinterpret_cast<const float4*>(x) + j);
    v.x = pack1(v.x);
    v.y = pack1(v.y);
    v.z = pack1(v.z);
    v.w = pack1(v.w);
    reinterpret_cast<float4*>(xp)[j] = v;
  }
  for (int64_t j = 4 * n4 + i; j < n; j += stride) xp[j] = pack1(__ldg(x + j));
}

int launch_pack(const float* x, float* xp, long long n, cudaStream_t st) {
  if (n == 0) return (int)cudaSuccess;
  const int vec4 = (((uintptr_t)x | (uintptr_t)xp) & 15) == 0;
  const long long items = vec4 ? (n + 3) / 4 : n;
  long long blocks = (items + kPackThreads - 1) / kPackThreads;
  if (blocks > 4096) blocks = 4096;  // then each thread strides
  pack_kernel<<<(unsigned)blocks, kPackThreads, 0, st>>>(x, xp, n, vec4);
  return (int)cudaGetLastError();
}

int lanes_for(int d, int vec) {
  int need = (d + vec - 1) / vec;
  int L = 1;
  while (L < need && L < 32) L <<= 1;
  return L;
}

// the share pass's launch for rows of d elements, vec per lane, in
// shares of t edges: kGroups lane groups of L lanes a block, and the
// block's src, w and dst staged in shared memory
struct ShareLayout {
  int L, threads;
  size_t smem;
};

ShareLayout share_layout(int d, int vec, int t) {
  const int L = lanes_for(d, vec);
  return {L, kGroups * L, (size_t)3 * kGroups * t * sizeof(uint32_t)};
}

// lets the share pass's instance fn take more than the default 48 KB of
// dynamic shared memory where the layout needs it; a cudaError_t
int allow_smem(const void* fn, const ShareLayout& l) {
  if (l.smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
}

template <typename T, int VEC, int MODE>
int launch(const void* x, const int32_t* sp, const float* wp,
           const int32_t* dp, const int64_t* rp, float* op, float* cp,
           long long n_rows, long long n_edges, int d, int t,
           int aligned16, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const ShareLayout l = share_layout(d, VEC, t);
  const int L = l.L;
  const long long n_shares = (n_edges + t - 1) / t;
  if (n_shares > 0) {
    const long long blocks = (n_shares + kGroups - 1) / kGroups;
    if (blocks > 0x7fffffffLL || l.smem > (size_t)kMaxSmem)
      return (int)cudaErrorInvalidValue;
    const int err = allow_smem((const void*)share_sum_kernel<VEC, MODE, T>, l);
    if (err != (int)cudaSuccess) return err;
    share_sum_kernel<VEC, MODE><<<(unsigned)blocks, l.threads, l.smem, st>>>(
        xp, sp, wp, dp, rp, op, cp, n_rows, n_edges, d, t, L, aligned16);
    const cudaError_t err2 = cudaGetLastError();
    if (err2 != cudaSuccess) return (int)err2;
  }
  const long long rows_per_block =
      (long long)(kFixThreads / L) * (L < kCarryRows ? L : kCarryRows);
  const long long fix_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (fix_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  carry_sum_kernel<VEC><<<(unsigned)fix_blocks, kFixThreads, 0, st>>>(
      rp, cp, op, n_rows, n_edges, d, t, L);
  return (int)cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// f(Tag<T>{}, Int<VEC>{}, Int<MODE>{}) for the share pass's instance of
// (bf16, vec, mode): the one place that maps them to template arguments
template <typename F>
int dispatch(int bf16, int vec, int mode, F&& f) {
  auto by_mode = [&](auto tag, auto v) {
    switch (mode) {
      case kBf16: return f(tag, v, Int<kBf16>{});
      case kPacked: return f(tag, v, Int<kPacked>{});
      default: return f(tag, v, Int<kF32>{});
    }
  };
  using Bf = Tag<__nv_bfloat16>;
  using Fp = Tag<float>;
  if (bf16) {
    switch (vec) {
      case 8: return by_mode(Bf{}, Int<8>{});
      case 4: return by_mode(Bf{}, Int<4>{});
      case 2: return by_mode(Bf{}, Int<2>{});
      default: return by_mode(Bf{}, Int<1>{});
    }
  }
  switch (vec) {
    case 4: return by_mode(Fp{}, Int<4>{});
    case 2: return by_mode(Fp{}, Int<2>{});
    default: return by_mode(Fp{}, Int<1>{});
  }
}

bool bad_args(long long d, int vec, int share_edges, int mode, int bf16) {
  const int max_vec = bf16 ? 8 : 4;
  return d <= 0 || share_edges <= 0 || vec < 1 || vec > max_vec ||
         (vec & (vec - 1)) != 0 || d % vec != 0 || mode < kF32 ||
         mode > kPacked || (bf16 != 0 && bf16 != 1);
}

}  // namespace

// x (n_in, d) f32 (bf16 == 0) or bf16 (bf16 == 1), src/dst (n_edges,)
// int32 with dst sorted, w (n_edges,) f32, rowptr (n_rows + 1,) int64
// the CSR row pointer of dst, out (n_rows, d) f32, carry
// (ceil(n_edges / share_edges), 2, d) f32 scratch, xpack (n_in, d) f32
// scratch for the packed table of an f32 x in packed mode (else
// unused, may be null).  vec: the elements of each x/out/carry access
// (f32: 1, 2 or 4; bf16: 1, 2, 4 or 8; d % vec == 0, x and xpack aligned
// to vec elements, out to vec floats).  mode: 0 f32, 1 bf16, 2 packed
// (the header).  Launches, on `stream`, the pack pass (packed mode, f32
// x), the share pass and the carry pass; returns a cudaError_t.
extern "C" int segment_spmm_launch(const void* x, const void* src,
                                   const void* w, const void* dst,
                                   const void* rowptr, void* out, void* carry,
                                   void* xpack, long long n_rows,
                                   long long n_in, long long n_edges, int d,
                                   int vec, int share_edges, int mode,
                                   int bf16, void* stream) {
  if (n_rows < 0 || n_in < 0 || n_edges < 0 ||
      bad_args(d, vec, share_edges, mode, bf16))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int aligned16 =
      (((uintptr_t)src | (uintptr_t)w | (uintptr_t)dst) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const float* wp = static_cast<const float*>(w);
  const int32_t* dp = static_cast<const int32_t*>(dst);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  float* op = static_cast<float*>(out);
  float* cp = static_cast<float*>(carry);
  if (mode == kPacked && !bf16) {  // the share pass gathers the table
    if (xpack == nullptr) return (int)cudaErrorInvalidValue;
    const int err = launch_pack(static_cast<const float*>(x),
                                static_cast<float*>(xpack), n_in * d, st);
    if (err != (int)cudaSuccess) return err;
    x = xpack;
  }
  return dispatch(bf16, vec, mode, [&](auto tag, auto v, auto m) {
    return launch<typename decltype(tag)::type, decltype(v)::value,
                  decltype(m)::value>(x, sp, wp, dp, rp, op, cp, n_rows,
                                      n_edges, d, share_edges, aligned16, st);
  });
}
