// Block segment sum over dst-sorted message rows, for NVIDIA Hopper
// (sm_90a).
//
//   out[r, :] (+)= sum_{e in [rowptr[r], rowptr[r+1])} t(msgs[e, :])
//
// Replaces scripts/diag/pallas_floor.py::make_kernel, the Pallas probe
// of K1's body without its gather: one program per BM = 64-row block
// streamed the dst-sorted message chunks of its edge range and summed
// them into a (BM, D) accumulator, in one of three modes.  In the port
// it is also the reduction half of sparse_spmm_impl: xla
// (recbole_gnn_tpu/ops/spmm.py::spmm_coo's x[src] * w and sorted
// segment_sum, and _spmm_coo_chunked, which accumulates chunk sums into
// one output), forward and backward, launched by ops/segment_sum.py.
//
// Terms t added per message element, always summed in f32:
//   0 f32     t(m) = m, or w[e] * m rounded once (__fmul_rn) when an
//             edge weight is given: the xla path, whose weight product
//             is taken here and not in a pass of its own
//   1 bf16    t(m) = bf16(m) rounded to nearest even (the probe's
//             n_pass=1: one bf16 one-hot product)
//   2 hilo    t(m) = hi + lo, hi = bf16(m), lo = bf16(m - hi) (n_pass=2)
//   3 stream  the probe's n_pass=0 copy floor: each BM-row block reads
//             every EC-aligned chunk its edge range touches, and adds
//             only msgs[c*EC + r] to row r where r = dst[c*EC] - block base
//
// What bounds it on H100: memory.  Per edge it reads one D-float
// message row, an int32 dst (and an f32 weight) and does D adds (2*D
// flops weighted): at most 2 flops per 4 bytes, far below the card's
// fp32 balance point, and tensor cores have no product to run.  The
// bound is the message stream read once (436 MB per SpMM at the
// LightGCN slice's shape) plus dst, weight, the row pointer and the
// output.  The design streams each message byte once, through shared
// memory, with many bytes in flight on every SM.
//
// Schedule of modes 0-2: equal edge shares, not rows or row blocks, as
// csrc/segment_spmm.cu schedules K1 (ops/segment_spmm.py's
// share_schedule is the arithmetic in torch).  The edge list is cut into
// shares of T consecutive edges (share s = [s*T, (s+1)*T) within
// [lo, hi) = [rowptr[0], rowptr[n_rows])), one warp each, whatever rows
// they fall in, so a hub row (or a block of them) is spread over every
// share it touches and no warp waits on one row.  dst[e] is the row of
// edge e in [lo, hi): a warp reads its share's first and last rows
// there, and whether each continues into the share before or after
// from the edges just outside it, so nothing searches rowptr.  The warp
// streams its share slab by slab; lane i reads the row of the i-th edge
// of each 32-edge piece, a ballot of the row changes cuts the piece into
// runs, and each run is summed with no test per edge, lanes across the
// columns (32*VEC at a time; a wider D takes up to kMaxPass column
// passes per walk of the share, one in bf16 and hilo).  A row that lies
// in one share is written by that share (out = sum, or out += sum when
// accumulating).  A row that crosses a share boundary can only be a
// share's first or last row: its partial sum goes to shared memory, and
// after the block's one barrier warp 0 adds the partials of each row in
// share order.  A row that stays inside the block's kWarps shares is
// then complete and written; a row that crosses the block's first or
// last edge goes to the block's carry slot 0 (the block's first row) or
// 1 (its last row) in an n_blocks x 2 x D workspace that the wrapper
// allocates, n_blocks from block_segment_sum_carry_rows below.
// A second kernel, launched right after on the same stream, takes one
// lane group per block boundary: the row crossing it, if the boundary
// is the row's first, gets the sum of its carries in block order (added
// to out when accumulating); its first blocks write the rows without
// edges as 0 (left alone when accumulating).  No value is added
// atomically: every sum has a fixed order and reruns repeat bit for
// bit.
//
// Staging: messages are contiguous in edge order, so the share pass is
// a pure stream.  Each warp owns a ring of kStages stages in shared
// memory; a slab is the next R edges of its share (R*D*4 ~ kSlabBytes
// for f32 messages, R*D*2 for bf16),
// their dst and weights.  Lane 0 loads slab k + kStages - 1 with TMA's
// 1-D bulk copy (cp.async.bulk, completion counted on the stage's
// mbarrier) before the warp sums slab k; the slab's dst and weights are
// copied as the whole 16-byte pieces around its edges.  Where a message
// row is not a multiple of 16 bytes, or an input is not 16-byte
// aligned, cp.async copies the slab instead (16-byte pieces where
// aligned).  __syncwarp orders a stage's reads before its refill.
//
// bf16 messages (activation_dtype: bfloat16; the xla path's x[src] *
// w.astype(bf16) and bf16 segment_sum), mode 0 with the edge weight
// only: the term of message element m is bf16(bf16(w) * m) (the weight
// rounded to bf16, the product rounded to bf16, as the JAX composition
// forms it; the products of a lane rounded in pairs with one conversion
// each), summed in f32; each output element is rounded to bf16 once (out
// = bf16(sum), or bf16(out + sum) when accumulating), by the share pass,
// the combine of a block's parts or the carry pass, whichever writes it.
// They take the same share pass, ring and carries as f32 messages: a
// slab holds R edges of R*D*2 bytes (~kSlabBytesBf16 = 4 KB: 32 rows at
// D = 64, as for f32), lanes multiply the staged bf16 pieces by the
// rounded weight in pairs of bf16 values (__hmul2, round to nearest
// even: the f32 product of two bf16 values rounded once, bit for bit)
// and widen the products in registers; partial sums and carries stay
// f32.  A warp's ring is half an f32 one, so the bf16 instances are
// held to 128 registers and four 4-warp blocks share an SM (f32: two):
// the pass waits on each warp's chain of dependent instructions per
// edge, not on the bytes, and more warps hide more of it.  Where a bf16
// row is not a multiple of 16 bytes (D % 8 != 0), or an input is not
// 16-byte aligned, cp.async copies the slab, the 2-byte values at its
// ends (or all of it, where the two sides do not agree modulo 4) by
// plain loads and stores.  The other modes and stream mode take f32
// messages only.

// Stream mode keeps its per-block definition and layout: one CTA per
// block stages the covered chunks through shared memory in kStageBytes
// tiles with cp.async, double-buffered, and adds the placeholder rows
// from the staged tiles, so its time is the stream's.
//
// Tried and dropped at the LightGCN slice's shape (PERF.md): for bf16
// messages, 8 KB slabs at two blocks per SM (0.20 ms against 0.139) and
// 3 KB slabs at five (the same as 4 KB at four), the f32 product
// rounded in pairs in place of the bf16 multiply (4 % slower); deeper rings
// (more slabs in flight per warp, fewer warps per SM), which were
// slower; cp.async staging for every input, slower than TMA there; a
// persistent grid (warps, or blocks, taking shares in turn), which was
// not faster; a binary search of rowptr for each share's first row (a
// chain of dependent loads, replaced by dst); and carries per share (T
// edges) with a carry pass per row, whose longest chain, the hub row's,
// set the carry pass's time and grew as T shrank.  The first Hopper
// layout (one CTA per 64-row block, its edge range cut into 16 warp
// shares) left the block holding the slice's 12,902-edge hub row to one
// CTA, half of the launch's time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kWarps = 4;           // shares (warps) per share-pass block
constexpr int kStages = 3;          // slabs in each warp's ring
constexpr int kSlabBytes = 8192;    // message bytes of one slab (rows % 4 == 0)
// bf16 messages: the slab's message bytes, and the share pass's blocks
// per SM in its __launch_bounds__ (f32: kSlabBytes and 2)
constexpr int kSlabBytesBf16 = 4096;
constexpr int kMinBlocksBf16 = 4;
constexpr int kPad = 8;             // dst/weight words beyond a slab's rows
constexpr int kMaxPass = 4;         // column passes summed in one walk
constexpr int kFixThreads = 256;    // threads per block of the carry pass
constexpr int kBlockThreads = 512;  // threads per block of stream mode
constexpr int kStageBytes = 16384;  // one stream-mode tile buffer
constexpr int kMaxSmem = 232448;    // what a block may use on H100
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kF32 = 0, kBf16 = 1, kHilo = 2, kStream = 3, kF32W = 4 };

// acc[q] += t(v[q]) for one lane's VEC message elements; bf16 and hilo
// round pairs with one conversion each (round to nearest even, as
// __float2bfloat16_rn does one at a time)
template <int MODE, int VEC>
__device__ __forceinline__ void add_terms(float* acc, const float* v,
                                          float w) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    if (MODE == kF32W) acc[q] += __fmul_rn(w, v[q]);  // the plain product
    if (MODE == kF32) acc[q] += v[q];
  }
  if (MODE == kF32 || MODE == kF32W) return;
  if constexpr (VEC == 1) {
    const float hi = __bfloat162float(__float2bfloat16_rn(v[0]));
    acc[0] += MODE == kBf16
                  ? hi
                  : hi + __bfloat162float(__float2bfloat16_rn(v[0] - hi));
  } else {
#pragma unroll
    for (int q = 0; q < VEC; q += 2) {
      const float2 hi =
          __bfloat1622float2(__floats2bfloat162_rn(v[q], v[q + 1]));
      if (MODE == kBf16) {
        acc[q] += hi.x;
        acc[q + 1] += hi.y;
      } else {  // hi + lo is exact in f32
        const float2 lo = __bfloat1622float2(
            __floats2bfloat162_rn(v[q] - hi.x, v[q + 1] - hi.y));
        acc[q] += hi.x + lo.x;
        acc[q + 1] += hi.y + lo.y;
      }
    }
  }
}

// acc[q] += bf16(w * m[q]) for one lane's VEC bf16 message elements at m
// (shared memory), w2 the weight rounded to bf16 in both halves: the
// product of two bf16 values taken by the bf16 multiply (__hmul2, round
// to nearest even), the same bits as the f32 product rounded once (two
// 8-bit significands make at most 16, exact in f32)
template <int VEC>
__device__ __forceinline__ void add_terms_bf16w(float* acc,
                                                const __nv_bfloat16* m,
                                                __nv_bfloat162 w2) {
  if constexpr (VEC == 1) {
    acc[0] += __bfloat162float(__hmul(w2.x, m[0]));
  } else {
    const __nv_bfloat162* m2 = reinterpret_cast<const __nv_bfloat162*>(m);
#pragma unroll
    for (int q = 0; q < VEC; q += 2) {
      const float2 t = __bfloat1622float2(__hmul2(w2, m2[q >> 1]));
      acc[q] += t.x;
      acc[q + 1] += t.y;
    }
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(float* v, const float* p) { v[0] = p[0]; }
  __device__ static void store(float* p, const float* v) { p[0] = v[0]; }
};
template <>
struct Vec<2> {
  __device__ static void load(float* v, const float* p) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void load(float* v, const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(unsigned s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one warp copies the n 4-byte words at g into shared memory at s:
// 16-byte pieces where s and g agree modulo 16, single words elsewhere
__device__ __forceinline__ void warp_copy(void* s, const void* g, int n,
                                          int lane) {
  const unsigned sa = smem_addr(s);
  const char* gp = static_cast<const char*>(g);
  int head = n, mid = 0;
  if (((sa ^ (unsigned)(uintptr_t)gp) & 15u) == 0) {
    head = (int)(((16u - ((unsigned)(uintptr_t)gp & 15u)) & 15u) >> 2);
    head = head < n ? head : n;
    mid = (n - head) >> 2;
  }
  for (int i = lane; i < head; i += 32) cp_async4(sa + 4 * i, gp + 4 * i);
  for (int i = lane; i < mid; i += 32)
    cp_async16(sa + 4 * head + 16 * i, gp + 4 * head + 16 * i);
  for (int i = head + 4 * mid + lane; i < n; i += 32)
    cp_async4(sa + 4 * i, gp + 4 * i);
}

// one warp copies n 2-byte values at g into shared memory at s: the
// 4-byte words through warp_copy where s and g agree modulo 4 (a value
// at either end by a plain load and store), every value that way where
// they do not
__device__ __forceinline__ void warp_copy_half(void* s, const void* g, int n,
                                               int lane) {
  unsigned short* sp = static_cast<unsigned short*>(s);
  const unsigned short* gp = static_cast<const unsigned short*>(g);
  if (((smem_addr(s) ^ (unsigned)(uintptr_t)g) & 3u) != 0) {
    for (int i = lane; i < n; i += 32) sp[i] = gp[i];
    return;
  }
  const int head = ((uintptr_t)g & 3u) && n > 0 ? 1 : 0;
  const int words = (n - head) >> 1;
  if (lane == 0 && head) sp[0] = gp[0];
  warp_copy(sp + head, gp + head, words, lane);
  if (lane == 0 && head + 2 * words < n)
    sp[head + 2 * words] = gp[head + 2 * words];
}

// n message elements of type T (float or bf16) from g to shared s
template <typename T>
__device__ __forceinline__ void copy_elems(void* s, const T* g, int n,
                                           int lane) {
  if constexpr (sizeof(T) == 4)
    warp_copy(s, g, n, lane);
  else
    warp_copy_half(s, g, n, lane);
}

// mbarrier and 1-D bulk copy (TMA) helpers
__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(unsigned s, const void* g,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(s),
      "l"(g), "r"(bytes), "r"(bar)
      : "memory");
}

// store one lane's VEC columns of a finished row: into its carry slot,
// or into out (added to it when accumulating; out is read only then)
template <int VEC>
__device__ __forceinline__ void put(float* o, const float* acc, bool add) {
  if (add) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) o[q] += acc[q];
  } else {
    Vec<VEC>::store(o, acc);
  }
}

// put() for an output of element type T: the sum narrowed to T once,
// after out's value is added when accumulating
template <typename T, int VEC>
__device__ __forceinline__ void put_t(T* o, const float* acc, bool add) {
  float v[VEC];
  if (add) {
    rows::Piece<T, VEC> old;
    old.ld(o);
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = old.get(q) + acc[q];
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = acc[q];
  }
  rows::store_f32<T, VEC>(o, v);
}

// out element o = sum, or o + sum when accumulating, narrowed to T once
template <typename T>
__device__ __forceinline__ void put1(T* o, float sum, bool add) {
  if constexpr (sizeof(T) == 4)
    *o = add ? *o + sum : sum;
  else
    *o = __float2bfloat16_rn(add ? __bfloat162float(*o) + sum : sum);
}

// The share pass: warp s of the grid sums share s, and block c combines
// the partial sums of its warps' split rows (see the header).  T: the
// message and output type (float, or bf16 in mode kF32W).  Shared
// memory per warp: kStages mbarriers (16 bytes each), then kStages
// slabs, each [R][d] messages (rounded up to 16 bytes) and R + kPad dst
// words (and as many weights); a slab's dst/weight word i is edge db +
// i, db = its first edge rounded down to a multiple of 4, so that whole
// 16-byte pieces can be bulk-copied around any edge range.  Then, per
// block, 2 f32 partial sums of d floats per warp and their rows.
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(kWarps * 32,
                                  sizeof(T) == 2 ? kMinBlocksBf16 : 2)
share_sum_kernel(const T* __restrict__ msgs,
                 const int32_t* __restrict__ dst,
                 const float* __restrict__ w,
                 const int64_t* __restrict__ rowptr,
                 T* __restrict__ out, float* __restrict__ carry,
                 int64_t n_rows, int64_t n_edges, int d, int t, int R,
                 int bulk, int accumulate) {
  constexpr bool kWeighted = MODE == kF32W;
  constexpr bool kHalf = sizeof(T) == 2;  // bf16 messages (kF32W only)
  static_assert(!kHalf || MODE == kF32W, "bf16 messages: mode 0 weighted");
  constexpr int CW = 32 * VEC;  // columns per pass
  // column passes per walk: bf16 and hilo take one, their longer term
  // code unrolled kMaxPass times ran slower (PERF.md); so do bf16
  // messages, whose terms round too
  constexpr int MP = MODE == kBf16 || MODE == kHilo || kHalf ? 1 : kMaxPass;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int RD = R + kPad;
  // R % 4 == 0, the slab rounded up to 16 bytes: stages stay aligned
  const int slab_floats = (int)(((size_t)R * d * sizeof(T) + 15) / 16 * 4);
  const int stage_floats = slab_floats + RD * (kWeighted ? 2 : 1);
  float* const region = smem + (size_t)warp * kStages * (4 + stage_floats);
  const unsigned bar0 = smem_addr(region);  // stage i's barrier: bar0 + 16 i
  float* const ring = region + 4 * kStages;
  const int nw = blockDim.x >> 5;
  float* const parts = smem + (size_t)nw * kStages * (4 + stage_floats);
  int* const part_row = reinterpret_cast<int*>(parts + (size_t)nw * 2 * d);

  // the block's edges [A, B): its nw shares of t edges
  const int64_t lo = min64(rowptr[0], n_edges);
  const int64_t hi = min64(rowptr[n_rows], n_edges);
  const int64_t tc = (int64_t)nw * t;
  const int64_t A = max64(blockIdx.x * tc, lo);
  const int64_t B = min64((blockIdx.x + 1) * tc, hi);
  if (A >= B) return;  // block-uniform, before the block's one barrier
  const int64_t s = (int64_t)blockIdx.x * nw + warp;
  const int64_t a = max64(s * t, lo);
  const int64_t b = min64((s + 1) * t, hi);
  auto share_body = [&]() {
    if (bulk && lane == 0) {
      for (int i = 0; i < kStages; ++i) bar_init(bar0 + 16 * i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();

    // slab k holds edges [s*t + k*R, s*t + (k+1)*R) within [a, b); the
    // q-th slab the warp loads goes to stage q % kStages
    const int64_t base = s * t;
    const int k0 = (int)((a - base) / R);
    const int k1 = (int)((b - 1 - base) / R) + 1;
    const int64_t n4 = n_edges & ~(int64_t)3;
    auto stage = [&](int k, int q) {
      float* st = ring + (q % kStages) * stage_floats;
      T* const sm = reinterpret_cast<T*>(st);
      int32_t* sd = reinterpret_cast<int32_t*>(st + slab_floats);
      float* sw = st + slab_floats + RD;
      const int64_t sb = base + (int64_t)k * R;
      const int64_t db = sb & ~(int64_t)3;
      const int64_t e0 = max64(sb, a), e1 = min64(sb + R, b);
      if (!bulk) {
        copy_elems<T>(sm + (e0 - sb) * d, msgs + e0 * d, (int)(e1 - e0) * d,
                      lane);
        warp_copy(sd + (e0 - db), dst + e0, (int)(e1 - e0), lane);
        if (kWeighted) warp_copy(sw + (e0 - db), w + e0, (int)(e1 - e0), lane);
        cp_async_commit();
        return;
      }
      // dst/weight: the 16-byte pieces around [e0, e1) below n4 in bulk,
      // the (at most 3) words past n4 by the lanes
      const int64_t q0 = e0 & ~(int64_t)3;
      const int64_t q1 = min64((e1 + 3) & ~(int64_t)3, n4);
      for (int64_t e = max64(q1, e0) + lane; e < e1; e += 32) {
        sd[e - db] = dst[e];
        if (kWeighted) sw[e - db] = w[e];
      }
      if (lane == 0) {
        const unsigned bar = bar0 + 16 * (q % kStages);
        const unsigned mbytes = (unsigned)((e1 - e0) * d * sizeof(T));
        const unsigned qbytes = q1 > q0 ? (unsigned)((q1 - q0) * 4) : 0u;
        // the stage's last reads (generic proxy) before the copy rewrites it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_expect(bar, mbytes + qbytes * (kWeighted ? 2 : 1));
        bulk_load(smem_addr(sm + (e0 - sb) * d), msgs + e0 * d, mbytes, bar);
        if (qbytes) {
          bulk_load(smem_addr(sd + (q0 - db)), dst + q0, qbytes, bar);
          if (kWeighted)
            bulk_load(smem_addr(sw + (q0 - db)), w + q0, qbytes, bar);
        }
      }
    };

    const int npass = (d + CW - 1) / CW;
    const int n_slabs = k1 - k0;
    // kStages - 1 slabs ahead (cp.async: as many groups, some empty)
    auto prefetch = [&](int qbase) {
      for (int k = 0; k < kStages - 1; ++k) {
        if (k < n_slabs)
          stage(k0 + k, qbase + k);
        else if (!bulk)
          cp_async_commit();
      }
    };
    prefetch(0);
    // while the first slabs fly: the share's first and last rows (dst[e]
    // is edge e's row for e in [lo, hi)), and whether each continues in
    // the share before (edge a - 1) or after (edge b)
    const int64_t first = dst[a];
    const int64_t last = dst[b - 1];
    const int64_t before = a > lo ? dst[a - 1] : -1;
    const int64_t after = b < hi ? dst[b] : -1;
    const bool first_split = before == first || after == first;
    const bool last_split = after == last;  // read only when last != first
    // a split row's partial sums go to the block's parts, combined below
    float* const slot0 = parts + (size_t)(2 * warp) * d;
    float* const slot1 = slot0 + d;
    if (lane == 0) {
      part_row[2 * warp] = first_split ? (int)first : -1;
      part_row[2 * warp + 1] = last != first && last_split ? (int)last : -1;
    }
    // a finished row's sums: into its part slot (f32), or into out
    // (added to it when accumulating; narrowed to T once)
    auto put_row = [&](float* slot, int64_t row, const float* acc, int col) {
      if constexpr (kHalf) {
        if (slot != nullptr)
          rows::store_f32<float, VEC>(slot + col, acc);
        else
          put_t<T, VEC>(out + row * d + col, acc, accumulate);
      } else {
        put<VEC>((slot != nullptr ? slot : out + row * d) + col, acc,
                 slot == nullptr && accumulate);
      }
    };

    int qbase = 0;  // slabs loaded by earlier walks
    for (int p0 = 0; p0 < npass; p0 += MP, qbase += n_slabs) {
      if (p0 > 0) prefetch(qbase);  // another walk for D > MP * CW
      float acc[MP][VEC];
#pragma unroll
      for (int p = 0; p < MP; ++p)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[p][q] = 0.f;
      int64_t cur = first;
      for (int k = k0; k < k1; ++k) {
        const int q = qbase + (k - k0);
        if (k + kStages - 1 < k1) {
          stage(k + kStages - 1, q + kStages - 1);
        } else if (!bulk) {
          cp_async_commit();  // empty: keeps the group count uniform
        }
        if (bulk)
          bar_wait(bar0 + 16 * (q % kStages), (unsigned)(q / kStages) & 1u);
        else
          cp_async_wait<kStages - 1>();
        __syncwarp();  // slab k is in, from every lane's copies
        const float* st = ring + (q % kStages) * stage_floats;
        const T* const sm = reinterpret_cast<const T*>(st);
        const int64_t sb = base + (int64_t)k * R;
        const int dofs = (int)(sb & 3);  // dst/weight word of edge sb
        const int32_t* sd =
            reinterpret_cast<const int32_t*>(st + slab_floats) + dofs;
        const float* sw = st + slab_floats + RD + dofs;
        const int i0 = (int)(max64(sb, a) - sb);
        const int i1 = (int)(min64(sb + R, b) - sb);
        // a row starts where dst changes: lane i reads the row of edge
        // j0 + i of each 32-edge piece, and the runs between the starts
        // are summed with no test per edge
        for (int j0 = i0; j0 < i1; j0 += 32) {
          const int cnt = i1 - j0 < 32 ? i1 - j0 : 32;
          const int row = lane < cnt ? sd[j0 + lane] : -1;
          const int up = __shfl_up_sync(kFull, row, 1);
          unsigned starts = __ballot_sync(
              kFull, lane < cnt && row != (lane == 0 ? (int)cur : up));
          int pos = 0;
          while (true) {
            const int end = starts ? __ffs(starts) - 1 : cnt;
#pragma unroll 4
            for (int e = j0 + pos; e < j0 + end; ++e) {
              const float we = kWeighted ? sw[e] : 0.f;
#pragma unroll
              for (int p = 0; p < MP; ++p) {
                const int col = (p0 + p) * CW + lane * VEC;
                if (p0 + p < npass && col < d) {  // d % VEC == 0
                  if constexpr (kHalf) {
                    add_terms_bf16w<VEC>(acc[p], sm + e * d + col,
                                         __float2bfloat162_rn(we));
                  } else {
                    float v[VEC];
                    Vec<VEC>::load(v, st + e * d + col);
                    add_terms<MODE, VEC>(acc[p], v, we);
                  }
                }
              }
            }
            if (!starts) break;
            // row cur is complete
            float* const o = cur == first && first_split ? slot0 : nullptr;
#pragma unroll
            for (int p = 0; p < MP; ++p) {
              const int col = (p0 + p) * CW + lane * VEC;
              if (p0 + p < npass && col < d) put_row(o, cur, acc[p], col);
#pragma unroll
              for (int q2 = 0; q2 < VEC; ++q2) acc[p][q2] = 0.f;
            }
            cur = __shfl_sync(kFull, row, end);
            starts &= starts - 1;
            pos = end;
          }
        }
        __syncwarp();  // slab k's stage is refilled at k + 1
      }
      // the share's last row (the first one too when it has one row)
      const bool carried = cur == first ? first_split : last_split;
      float* const o = carried ? (cur == first ? slot0 : slot1) : nullptr;
#pragma unroll
      for (int p = 0; p < MP; ++p) {
        const int col = (p0 + p) * CW + lane * VEC;
        if (p0 + p < npass && col < d) put_row(o, cur, acc[p], col);
      }
    }
  };

  // Warp 0 walks the parts in share order and sums each row's run: a
  // row that crosses the block's first or last edge goes to the
  // block's carry slot (0: the block's first row, 1: its last), any
  // other row is complete and goes to out.
  auto combine_parts = [&](int64_t first_row, int64_t before,
                           int64_t after) {
    float* const cslot = carry + (int64_t)blockIdx.x * 2 * d;
    for (int col = lane; col < d; col += 32) {
      int64_t run = -1;
      float sum = 0.f;
      for (int i = 0; i <= 2 * nw; ++i) {
        const int64_t r = i < 2 * nw ? part_row[i] : -2;  // -2: the end
        if (r == -1) continue;
        if (r != run && run >= 0) {
          if (run == before || run == after)
            cslot[(run == first_row ? 0 : d) + col] = sum;
          else
            put1<T>(out + run * d + col, sum, accumulate);
        }
        if (r != run) {
          run = r;
          sum = 0.f;
        }
        if (r >= 0) sum += parts[(size_t)i * d + col];
      }
    }
  };

  // the block's first row, and the rows of the edges just before and
  // after it, loaded while the shares stream
  int64_t blk_first = 0, blk_before = -1, blk_after = -1;
  if (warp == 0) {
    blk_first = dst[A];
    if (A > lo) blk_before = dst[A - 1];
    if (B < hi) blk_after = dst[B];
  }
  if (a < b)
    share_body();
  else if (lane < 2)
    part_row[2 * warp + lane] = -1;
  __syncthreads();  // every warp's partials are in
  if (warp == 0) combine_parts(blk_first, blk_before, blk_after);
}

// acc += the N carry slots at c, c + 2d, ...: N loads issued together,
// added in order
template <int VEC, int N>
__device__ __forceinline__ void add_carries(float* acc, const float* c,
                                            int d) {
  rows::Piece<float, VEC> v[N];
#pragma unroll
  for (int u = 0; u < N; ++u) v[u].ld(c + u * 2 * (int64_t)d);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] += v[u].get(q);
}

// the sum of a split row's carries, in share order: its first share
// s0's slot `slot`, then slot 0 of shares s0+1..s1 (batches of 16, 8,
// 4, 2, 1 loads issued together); nothing for an empty row (s1 < s0)
template <int VEC>
__device__ __forceinline__ void sum_carries(float* acc, const float* carry,
                                            int64_t s0, int64_t s1, int slot,
                                            int d, int col) {
  constexpr int kBig = VEC > 4 ? 8 : 16;  // 8 for 8-wide pieces
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  if (s1 < s0) return;
  rows::Piece<float, VEC> first;
  first.ld(carry + (s0 * 2 + slot) * (int64_t)d + col);
  first.get_all(acc);
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

// The carry pass.  Blocks [0, zero_blocks) (none when accumulating):
// each warp takes 32 rows, reads their pointers and writes the empty
// ones as 0.  The other blocks: one lane group of L lanes per share
// boundary s*t (s = 1 .. n_shares - 1).  The row r holding edge s*t,
// if it also holds edge s*t - 1 and s is the first boundary it crosses,
// gets the sum of its carries in share order (added to out when
// accumulating).  Rows inside one share were written by the share pass.
template <typename T, int VEC>
__global__ void __launch_bounds__(kFixThreads)
carry_sum_kernel(const int32_t* __restrict__ dst,
                 const int64_t* __restrict__ rowptr,
                 const float* __restrict__ carry, T* __restrict__ out,
                 int64_t n_rows, int64_t n_edges, int d, int t, int L,
                 int zero_blocks, int accumulate) {
  const int64_t lo = min64(rowptr[0], n_edges);
  const int64_t hi = min64(rowptr[n_rows], n_edges);
  if ((int)blockIdx.x < zero_blocks) {
    const int lane = threadIdx.x & 31;
    const int64_t base = (int64_t)blockIdx.x * kFixThreads + threadIdx.x - lane;
    const int64_t r = base + lane;
    const bool empty = r < n_rows && min64(rowptr[r], n_edges) >=
                                         min64(rowptr[r + 1], n_edges);
    unsigned todo = __ballot_sync(kFull, empty);
    float zero[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) zero[q] = 0.f;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      for (int col = lane * VEC; col < d; col += 32 * VEC)
        rows::store_f32<T, VEC>(out + (base + j) * (int64_t)d + col, zero);
    }
    return;
  }
  const int64_t g =
      ((int64_t)(blockIdx.x - zero_blocks) * kFixThreads + threadIdx.x) / L;
  const int sub = threadIdx.x % L;
  const int64_t x = (g + 1) * t;  // the boundary's first edge
  if (x <= lo || x >= hi) return;
  const int64_t r = dst[x];
  if (dst[x - 1] != r) return;  // no row crosses this boundary
  const int64_t b0 = min64(rowptr[r], n_edges);
  if (b0 / t != g) return;  // r crossed an earlier boundary
  const int64_t b1 = min64(rowptr[r + 1], n_edges);
  const int64_t s0 = b0 / t;
  const int slot = b0 == max64(s0 * t, lo) ? 0 : 1;
  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int col = c0 + sub * VEC;
    if (col >= d) break;
    float acc[VEC];
    sum_carries<VEC>(acc, carry, s0, (b1 - 1) / t, slot, d, col);
    put_t<T, VEC>(out + r * d + col, acc, accumulate);
  }
}

int lanes_for(int d, int vec) {
  int need = (d + vec - 1) / vec;
  int L = 1;
  while (L < need && L < 32) L <<= 1;
  return L;
}

// write the block's accumulated rows [0, rows) (stream mode)
__device__ __forceinline__ void write_rows(const float* acc, float* out,
                                           int64_t base, int rows, int d,
                                           int accumulate) {
  for (int i = threadIdx.x; i < rows * d; i += kBlockThreads) {
    float* o = out + base * d + i;
    *o = accumulate ? *o + acc[i] : acc[i];
  }
}

// stage tile t of the covered range (rows [t0, t0 + n) of msgs) into buf
__device__ __forceinline__ void stage_tile(const float* msgs, int64_t t0,
                                           int64_t n, int d, float* buf) {
  const int64_t pieces = n * d / 4;  // 16-byte pieces; n * d % 4 == 0
  const float4* src = reinterpret_cast<const float4*>(msgs + t0 * d);
  for (int64_t p = threadIdx.x; p < pieces; p += kBlockThreads)
    cp_async16(smem_addr(reinterpret_cast<float4*>(buf) + p), src + p);
}

__global__ void __launch_bounds__(kBlockThreads)
block_stream_kernel(const float* __restrict__ msgs,
                    const int32_t* __restrict__ dst,
                    const int64_t* __restrict__ rowptr,
                    float* __restrict__ out, int64_t n_rows, int d, int bm,
                    int ec, int tile_rows, int accumulate) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;  // [bm][d]
  const int acc_floats = (bm * d + 3) & ~3;
  float* stage = smem + acc_floats;  // [2][tile_rows][d]
  const int64_t base = (int64_t)blockIdx.x * bm;
  const int rows = (int)((n_rows - base) < bm ? (n_rows - base) : bm);
  const int64_t beg = rowptr[base];
  const int64_t end = rowptr[base + rows];
  for (int i = threadIdx.x; i < bm * d; i += kBlockThreads) acc[i] = 0.f;
  __syncthreads();

  if (end > beg) {
    const int64_t g0 = (beg / ec) * ec;             // first covered chunk
    const int64_t g1 = ((end - 1) / ec + 1) * ec;   // past the last one
    const int64_t n_tiles = (g1 - g0 + tile_rows - 1) / tile_rows;
    const int64_t tile_floats = (int64_t)tile_rows * d;
    stage_tile(msgs, g0, (g1 - g0) < tile_rows ? (g1 - g0) : tile_rows, d,
               stage);
    cp_async_commit();
    for (int64_t t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) {
        const int64_t n0 = g0 + (t + 1) * tile_rows;
        stage_tile(msgs, n0, (g1 - n0) < tile_rows ? (g1 - n0) : tile_rows,
                   d, stage + ((t + 1) & 1) * tile_floats);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait<1>();
      __syncthreads();    // tile t is in, from every thread's copies
      const int64_t t0 = g0 + t * tile_rows;
      const int64_t t1 = (g1 - t0) < tile_rows ? g1 : t0 + tile_rows;
      const float* buf = stage + (t & 1) * tile_floats;
      for (int64_t c = t0 / ec; c * ec < t1; ++c) {
        const int r = (int)(dst[c * ec] - base);  // the placeholder row
        const int64_t g = c * ec + r;
        if (r >= 0 && r < bm && g >= t0 && g < t1) {
          for (int k = threadIdx.x; k < d; k += kBlockThreads)
            acc[r * d + k] += buf[(g - t0) * d + k];
        }
      }
      __syncthreads();    // buffer t & 1 is refilled at t + 2
    }
  }
  write_rows(acc, out, base, rows, d, accumulate);
}

int launch_stream(const float* m, const int32_t* dp, const int64_t* rp,
                  float* op, long long n_rows, int d, int bm, int ec,
                  int accumulate, cudaStream_t st) {
  const long long blocks = (n_rows + bm - 1) / bm;
  if (blocks > 0x7fffffffLL || ec <= 0 || ec % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int tile_rows = (kStageBytes / (4 * d)) & ~3;
  if (tile_rows < 4) tile_rows = 4;
  const size_t smem =
      ((size_t)((bm * d + 3) & ~3) + 2 * (size_t)tile_rows * d) *
      sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_stream_kernel<<<(unsigned)blocks, kBlockThreads, smem, st>>>(
      m, dp, rp, op, n_rows, d, bm, ec, tile_rows, accumulate);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_carry_vec(const int32_t* dp, const int64_t* rp, const float* cp,
                     T* op, long long n_rows, long long n_edges, int d,
                     int t, long long n_shares, int accumulate,
                     cudaStream_t st) {
  const int L = lanes_for(d, VEC);
  const long long zero_blocks =
      accumulate ? 0 : (n_rows + kFixThreads - 1) / kFixThreads;
  const long long groups_per_block = kFixThreads / L;
  const long long bound_blocks =
      n_shares > 1 ? (n_shares - 1 + groups_per_block - 1) / groups_per_block
                   : 0;
  const long long blocks = zero_blocks + bound_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  carry_sum_kernel<T, VEC><<<(unsigned)blocks, kFixThreads, 0, st>>>(
      dp, rp, cp, op, n_rows, n_edges, d, t, L, (int)zero_blocks,
      accumulate);
  return (int)cudaGetLastError();
}

// the carry pass with the widest stores (16 bytes at most) that d and
// out's alignment allow
template <typename T>
int launch_carry(const int32_t* dp, const int64_t* rp, const float* cp,
                 T* op, long long n_rows, long long n_edges, int d, int t,
                 long long n_shares, int accumulate, cudaStream_t st) {
  const uintptr_t o = (uintptr_t)op;
  const int e = (int)sizeof(T);
  if constexpr (sizeof(T) == 2) {
    if (d % 8 == 0 && o % 16 == 0)
      return launch_carry_vec<T, 8>(dp, rp, cp, op, n_rows, n_edges, d, t,
                                    n_shares, accumulate, st);
  }
  if (d % 4 == 0 && o % (4 * e) == 0)
    return launch_carry_vec<T, 4>(dp, rp, cp, op, n_rows, n_edges, d, t,
                                  n_shares, accumulate, st);
  if (d % 2 == 0 && o % (2 * e) == 0)
    return launch_carry_vec<T, 2>(dp, rp, cp, op, n_rows, n_edges, d, t,
                                  n_shares, accumulate, st);
  return launch_carry_vec<T, 1>(dp, rp, cp, op, n_rows, n_edges, d, t,
                                n_shares, accumulate, st);
}

// the share pass's layout for rows of d elements of `elem` bytes: R
// edges per slab, one warp's shared memory (its ring, and its two
// partial sums and their rows), and the warps (shares) per block, fewer
// where a wide row leaves room for fewer rings (0: the row does not fit)
struct ShareLayout {
  int R;
  size_t warp_bytes;
  int warps;
};

ShareLayout share_layout(int d, bool weighted, int elem) {
  ShareLayout l;
  l.R = ((elem == 2 ? kSlabBytesBf16 : kSlabBytes) / (elem * d)) & ~3;
  if (l.R < 4) l.R = 4;
  const size_t slab_floats = ((size_t)l.R * d * elem + 15) / 16 * 4;
  l.warp_bytes =
      ((size_t)kStages *
           (4 + slab_floats + (size_t)(l.R + kPad) * (weighted ? 2 : 1)) +
       2 * (size_t)d + 2) *
      sizeof(float);
  const size_t warps = kMaxSmem / l.warp_bytes;
  l.warps = warps < (size_t)kWarps ? (int)warps : kWarps;
  return l;
}

template <typename T, int VEC, int MODE>
int launch_shares(const T* m, const int32_t* dp, const float* wp,
                  const int64_t* rp, T* op, float* cp, long long n_rows,
                  long long n_edges, int d, int t, int bulk, int accumulate,
                  cudaStream_t st) {
  const ShareLayout l = share_layout(d, MODE == kF32W, (int)sizeof(T));
  const int R = l.R, warps = l.warps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const long long tc = (long long)warps * t;  // edges per block
  const long long blocks = (n_edges + tc - 1) / tc;
  if (tc > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    const size_t smem = l.warp_bytes * warps;
    const cudaError_t err = cudaFuncSetAttribute(
        share_sum_kernel<T, VEC, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    share_sum_kernel<T, VEC, MODE><<<(unsigned)blocks, warps * 32, smem, st>>>(
        m, dp, wp, rp, op, cp, n_rows, n_edges, d, t, R, bulk, accumulate);
    const cudaError_t err2 = cudaGetLastError();
    if (err2 != cudaSuccess) return (int)err2;
  }
  // the carries are per block: the carry pass sees shares of tc edges
  return launch_carry<T>(dp, rp, cp, op, n_rows, n_edges, d, (int)tc, blocks,
                         accumulate, st);
}

// the share pass's mode for (mode, weighted); -1 for a combination the
// kernel does not take (a weight outside mode 0, bf16 messages outside
// mode 0 with a weight)
int share_mode(int mode, bool weighted, bool bf16) {
  if (mode < kF32 || mode > kHilo || (weighted && mode != kF32) ||
      (bf16 && (mode != kF32 || !weighted)))
    return -1;
  return weighted ? kF32W : mode;
}

template <int VEC>
int launch_mode(int mode, const float* m, const int32_t* dp, const float* wp,
                const int64_t* rp, float* op, float* cp, long long n_rows,
                long long n_edges, int d, int t, int bulk, int accumulate,
                cudaStream_t st) {
  switch (mode) {
    case kF32W:
      return launch_shares<float, VEC, kF32W>(m, dp, wp, rp, op, cp, n_rows,
                                              n_edges, d, t, bulk, accumulate,
                                              st);
    case kF32:
      return launch_shares<float, VEC, kF32>(m, dp, wp, rp, op, cp, n_rows,
                                             n_edges, d, t, bulk, accumulate,
                                             st);
    case kBf16:
      return launch_shares<float, VEC, kBf16>(m, dp, wp, rp, op, cp, n_rows,
                                              n_edges, d, t, bulk, accumulate,
                                              st);
    default:
      return launch_shares<float, VEC, kHilo>(m, dp, wp, rp, op, cp, n_rows,
                                              n_edges, d, t, bulk, accumulate,
                                              st);
  }
}

bool bad_vec(int vec, int d, bool bf16) {
  return vec < 1 || vec > (bf16 ? 8 : 4) || (vec & (vec - 1)) != 0 ||
         d % vec != 0;
}

}  // namespace

// Rows of the carry workspace of modes 0-2: one slot pair per block of
// the share pass's grid over n_edges d-element rows (f32, or bf16 where
// bf16 == 1) in shares of share_edges, with an edge weight or not; -1
// where the launch would refuse the shape.
extern "C" long long block_segment_sum_carry_rows(long long n_edges, int d,
                                                  int weighted,
                                                  int share_edges, int bf16) {
  if (n_edges < 0 || d <= 0 || share_edges <= 0) return -1;
  const ShareLayout l = share_layout(d, weighted != 0, bf16 ? 2 : 4);
  if (l.warps < 1) return -1;
  const long long tc = (long long)l.warps * share_edges;
  return (n_edges + tc - 1) / tc;
}

// msgs (n_edges, d) f32 (bf16 == 0) or bf16 (bf16 == 1; mode 0 with a
// weight only), dst (n_edges,) int32 sorted, rowptr (n_rows + 1,) int64
// its CSR row pointer, weight (n_edges,) f32 or null (mode 0 only), out
// (n_rows, d) of the messages' type.  Modes 0-2: carry
// (block_segment_sum_carry_rows(n_edges, d, weight != null, share_edges,
// bf16), 2, d) f32 scratch; vec: the elements per lane of the
// shared-memory reads and of the out/carry stores of the share pass (f32:
// 1, 2 or 4; bf16: 1, 2, 4 or 8; d % vec == 0, out aligned to vec
// elements).  Launches the share pass and the carry pass on `stream`.
// Mode 3 (stream, f32): bm-row blocks, ec-edge chunks, n_edges % ec ==
// 0, msgs 16-byte aligned; carry, vec and share_edges unused.  Returns a
// cudaError_t.
extern "C" int block_segment_sum_launch(const void* msgs, const void* dst,
                                        const void* rowptr,
                                        const void* weight, void* out,
                                        void* carry, long long n_rows,
                                        long long n_edges, int d, int vec,
                                        int mode, int bm, int ec,
                                        int share_edges, int accumulate,
                                        int bf16, void* stream) {
  if (n_rows < 0 || n_edges < 0 || d <= 0 || (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  const int smode = mode == kStream
                        ? (weight != nullptr || bf16 ? -1 : kStream)
                        : share_mode(mode, weight != nullptr, bf16 != 0);
  if (smode < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* dp = static_cast<const int32_t*>(dst);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const float* wp = static_cast<const float*>(weight);
  float* cp = static_cast<float*>(carry);
  if (smode == kStream) {
    if (bm <= 0) return (int)cudaErrorInvalidValue;
    return launch_stream(static_cast<const float*>(msgs), dp, rp,
                         static_cast<float*>(out), n_rows, d, bm, ec,
                         accumulate, st);
  }
  if (share_edges <= 0 || bad_vec(vec, d, bf16 != 0))
    return (int)cudaErrorInvalidValue;
  // bulk copies need 16-byte aligned sources and whole 16-byte rows
  const int bulk =
      (d * (bf16 ? 2 : 4)) % 16 == 0 &&
      (((uintptr_t)msgs | (uintptr_t)dst | (uintptr_t)weight) & 15) == 0;
  if (bf16) {
    using B = __nv_bfloat16;
    const B* m = static_cast<const B*>(msgs);
    B* op = static_cast<B*>(out);
#define BF16W(V)                                                           \
  launch_shares<B, V, kF32W>(m, dp, wp, rp, op, cp, n_rows, n_edges, d,    \
                             share_edges, bulk, accumulate, st)
    switch (vec) {
      case 8: return BF16W(8);
      case 4: return BF16W(4);
      case 2: return BF16W(2);
      default: return BF16W(1);
    }
#undef BF16W
  }
  const float* m = static_cast<const float*>(msgs);
  float* op = static_cast<float*>(out);
  switch (vec) {
    case 4:
      return launch_mode<4>(smode, m, dp, wp, rp, op, cp, n_rows, n_edges, d,
                            share_edges, bulk, accumulate, st);
    case 2:
      return launch_mode<2>(smode, m, dp, wp, rp, op, cp, n_rows, n_edges, d,
                            share_edges, bulk, accumulate, st);
    default:
      return launch_mode<1>(smode, m, dp, wp, rp, op, cp, n_rows, n_edges, d,
                            share_edges, bulk, accumulate, st);
  }
}
