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
// bf16 x (activation_dtype: bfloat16): the kernel reads the bf16 rows
// itself (rows.cuh: 16-byte loads of 8 values where the row allows; no
// f32 copy of x is made) and writes an f32 output, as the TPU kernel
// does whatever x's type.  The terms as _pallas_spmm_jit forms them from
// a bf16 x: f32x2 and bf16 take the weight rounded to bf16
// (w.astype(x.dtype)); f32x2 adds the product of the two bf16 values,
// exact in f32 (two 8-bit significands make at most 16), and bf16 adds
// that product rounded to bf16; packed
// casts x to f32 (hi = x, lo = 0) and multiplies by the f32 weight, then
// splits m as above.  The transpose gets an f32 cotangent (the forward's
// output type) and runs the f32 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kGroups = 16;       // shares (lane groups) per block
constexpr int kUnroll = 8;        // row gathers in flight per lane group
constexpr int kFixThreads = 256;  // threads per block of the carry pass
constexpr int kCarryRows = 8;     // rows per lane group of the carry pass
constexpr int kMaxSmem = 232448;  // what a block may use on H100
constexpr unsigned kFull = 0xffffffffu;
constexpr int kF32 = 0, kBf16 = 1, kPacked = 2;  // precision modes

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_trunc(float v) {
  return __int_as_float(__float_as_int(v) & 0xffff0000);
}

// acc (and, in packed mode, lo) += the term of weight wt on the x piece
// v (x's element type T; a bf16 x's weight is rounded to bf16 but in
// packed mode)
template <int MODE, typename T, int VEC>
__device__ __forceinline__ void add_term(float* acc, float* lo, float wt,
                                         const rows::Piece<T, VEC>& v) {
  if constexpr (sizeof(T) == 2 && MODE != kPacked) wt = bf16_rn(wt);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float xk = v.get(k);
    if constexpr (MODE == kF32) {
      acc[k] += wt * xk;
    } else if constexpr (MODE == kBf16) {
      acc[k] += bf16_rn(__fmul_rn(wt, xk));
    } else {
      const float xh = bf16_trunc(xk);
      const float xl = bf16_rn(__fsub_rn(xk, xh));
      const float m = __fmul_rn(__fadd_rn(xh, xl), wt);
      const float mh = bf16_trunc(m);
      acc[k] += mh;
      lo[k] += bf16_rn(__fsub_rn(m, mh));
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

int lanes_for(int d, int vec) {
  int need = (d + vec - 1) / vec;
  int L = 1;
  while (L < need && L < 32) L <<= 1;
  return L;
}

template <typename T, int VEC, int MODE>
int launch(const void* x, const int32_t* sp, const float* wp,
           const int32_t* dp, const int64_t* rp, float* op, float* cp,
           long long n_rows, long long n_edges, int d, int t, int L,
           int aligned16, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const long long n_shares = (n_edges + t - 1) / t;
  if (n_shares > 0) {
    const long long blocks = (n_shares + kGroups - 1) / kGroups;
    const size_t smem = (size_t)3 * kGroups * t * sizeof(uint32_t);
    if (blocks > 0x7fffffffLL || smem > (size_t)kMaxSmem)
      return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          share_sum_kernel<VEC, MODE, T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    share_sum_kernel<VEC, MODE><<<(unsigned)blocks, kGroups * L, smem, st>>>(
        xp, sp, wp, dp, rp, op, cp, n_rows, n_edges, d, t, L, aligned16);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows_per_block =
      (long long)(kFixThreads / L) * (L < kCarryRows ? L : kCarryRows);
  const long long fix_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (fix_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  carry_sum_kernel<VEC><<<(unsigned)fix_blocks, kFixThreads, 0, st>>>(
      rp, cp, op, n_rows, n_edges, d, t, L);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_mode(int mode, const void* xp, const int32_t* sp,
                const float* wp, const int32_t* dp, const int64_t* rp,
                float* op, float* cp, long long n_rows, long long n_edges,
                int d, int t, int L, int aligned16, cudaStream_t st) {
  switch (mode) {
    case kBf16:
      return launch<T, VEC, kBf16>(xp, sp, wp, dp, rp, op, cp, n_rows,
                                   n_edges, d, t, L, aligned16, st);
    case kPacked:
      return launch<T, VEC, kPacked>(xp, sp, wp, dp, rp, op, cp, n_rows,
                                     n_edges, d, t, L, aligned16, st);
    default:
      return launch<T, VEC, kF32>(xp, sp, wp, dp, rp, op, cp, n_rows,
                                  n_edges, d, t, L, aligned16, st);
  }
}

}  // namespace

// x (n_in, d) f32 (bf16 == 0) or bf16 (bf16 == 1), src/dst (n_edges,)
// int32 with dst sorted, w (n_edges,) f32, rowptr (n_rows + 1,) int64
// the CSR row pointer of dst, out (n_rows, d) f32, carry
// (ceil(n_edges / share_edges), 2, d) f32 scratch.  vec: the elements of
// each x/out/carry access (f32: 1, 2 or 4; bf16: 1, 2, 4 or 8; d % vec
// == 0, x aligned to vec elements, out to vec floats).  mode: 0 f32, 1
// bf16, 2 packed (the header).  Launches the share pass and the carry
// pass on `stream`; returns a cudaError_t.
extern "C" int segment_spmm_launch(const void* x, const void* src,
                                   const void* w, const void* dst,
                                   const void* rowptr, void* out, void* carry,
                                   long long n_rows, long long n_edges, int d,
                                   int vec, int share_edges, int mode,
                                   int bf16, void* stream) {
  const int max_vec = bf16 ? 8 : 4;
  if (n_rows < 0 || n_edges < 0 || d <= 0 || share_edges <= 0 || vec < 1 ||
      vec > max_vec || (vec & (vec - 1)) != 0 || d % vec != 0 ||
      mode < kF32 || mode > kPacked || (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int L = lanes_for(d, vec);
  const int aligned16 =
      (((uintptr_t)src | (uintptr_t)w | (uintptr_t)dst) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const float* wp = static_cast<const float*>(w);
  const int32_t* dp = static_cast<const int32_t*>(dst);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  float* op = static_cast<float*>(out);
  float* cp = static_cast<float*>(carry);
#define SEG_LAUNCH(T, V)                                                  \
  launch_mode<T, V>(mode, x, sp, wp, dp, rp, op, cp, n_rows, n_edges, d, \
                    share_edges, L, aligned16, st)
  if (bf16) {
    switch (vec) {
      case 8: return SEG_LAUNCH(__nv_bfloat16, 8);
      case 4: return SEG_LAUNCH(__nv_bfloat16, 4);
      case 2: return SEG_LAUNCH(__nv_bfloat16, 2);
      default: return SEG_LAUNCH(__nv_bfloat16, 1);
    }
  }
  switch (vec) {
    case 4: return SEG_LAUNCH(float, 4);
    case 2: return SEG_LAUNCH(float, 2);
    default: return SEG_LAUNCH(float, 1);
  }
#undef SEG_LAUNCH
}
