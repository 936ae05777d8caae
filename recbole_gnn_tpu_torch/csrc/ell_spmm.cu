// Bucketed-ELL SpMM, for NVIDIA Hopper (sm_90a).
//
//   out[n, :] = sum over the slots s of node n's virtual rows of
//               w[s] * x[idx[s], :]
//
// Replaces recbole_gnn_tpu/ops/ell_spmm.py::ell_spmm (bucket_gather_sum /
// _bucket_sum), the JAX package's default sparse SpMM
// (sparse_spmm_impl: ell).  That is an XLA composition, not a Pallas
// kernel: per bucket an (n_b * K_b, D) row gather into HBM and an einsum
// over the slot axis, then a segment sum over the virtual rows of split
// nodes and one gather of the pooled bucket outputs through node_src.
// This kernel reads the same host-built layout (ops/ell_spmm.py's
// build_ell, the JAX numpy code copied) and makes none of those
// intermediates: the messages w * x[idx] are summed in registers.
//
// What bounds it on H100.  The DRAM traffic the work needs is x read
// once, out written once and each real slot's 4-byte index and 4-byte
// weight: at the LightGCN slice shape (70,841 nodes, D = 64, 1.70M
// edges) about 51 MB, 15 us at 3.35 TB/s.  What the kernel does is one
// D-float row gather of x per slot, 519 MB at that shape, which the L2
// serves (x is 18.1 MB of its 50 MB): the row pass takes the same time
// with the L2 warm, with every call writing new output memory (as in a
// training step, where autograd keeps each layer's output) and inside
// the step, and 4 % more flushed, so the slot and output streams do not
// evict x to any effect.  Its time is set by how many gathers are in
// flight against the L2's latency: each lane group keeps kUnroll of
// them, and the row pass is capped at 80 registers so that three
// 256-thread blocks fit on an SM, not two, at the price of a few bytes
// of spills (ptxas -v).  The read-once streams (idx, w, vdst) are
// loaded, and out and the workspace stored, evict-first (.cs), which
// keeps them from displacing x.  Measured against this kernel on the
// card and dropped, each being slower: an L2 evict_last policy for x
// with a bulk L2 prefetch at the start of the pass; skipping the pad
// slots by a per-row count of real slots; and a warp-uniform trip
// count for that skip.  Pad slots all gather
// row 0, which stays in every SM's L1, so skipping them saves almost no
// L2 traffic, while the bookkeeping costs registers and instructions
// on every slot.
//
// Schedule.  Two kernels on the caller's stream, no more:
//   1. the row pass walks every virtual row of every bucket in ONE
//      launch.  A bucket table passed by value (at most 32 buckets)
//      gives each bucket its width K, row count, first slot, first
//      virtual row and first block; a block finds its bucket by a scan
//      of that table.  The blocks of the widest buckets get the lowest
//      indices, so the longest blocks start first.  A lane group of L
//      lanes (L*VEC columns at a time; D wider than 32*VEC takes
//      several passes) owns rpg = max(1, 64 / K) consecutive rows of one
//      bucket: the rows are fixed-length, so every group has the same
//      work and needs no carry, and the groups of a warp never diverge.
//      Narrow buckets (K = 4, 8) pack several rows into each group, and
//      at D = 64 two 16-lane groups share a warp.  The group loads L
//      slots' indices and weights at once, one per lane (the next L are
//      loaded before the current ones are used), passes them round by
//      shuffles and keeps kUnroll row gathers in flight.  A finished row
//      goes to its node's output row when the node has one virtual row
//      (vdst >= 0), else to row -(1 + vdst) of a workspace that the
//      wrapper allocates (one D-float row per virtual row of a split
//      node).
//   2. the combine pass writes the rest of the nodes, one lane group
//      each: a split node (degree above K_CAP) as the sum of its
//      workspace rows in row order, kCombineUnroll loads in flight, an
//      isolated node (PAD ids 0 among them) as 0.  It is not launched
//      when there are no such nodes.
// Each row is summed in slot order in f32 (fused multiply-adds); no
// value is added atomically, so reruns repeat bit for bit.  A pad slot
// (source row 0, weight 0) is gathered and added like any other slot:
// for a finite x[0] it adds +0 or -0, which leaves the row's value as
// the sum of its real slots (ops/ell_spmm.py's ell_spmm_pad_free_plain),
// and a non-finite x[0] spreads NaN as the plain version's einsum does.
//
// bf16 x (activation_dtype: bfloat16; the JAX package's _bucket_sum
// with a bf16 x, x[idx] * w.astype(bf16) summed by an einsum into a bf16
// output): the same two passes over bf16 rows, read by the kernel
// itself (rows.cuh: 16-byte loads of 8 values where the row allows), no
// f32 copy of x made.  Each slot weight is rounded to bf16 once, where
// the lane loads it; the product of two bf16 values is exact in f32, so
// the row is the f32 sum of the exact terms, and each output element is
// rounded to bf16 once: where a single-row node's row is written, or,
// for a split node, where the combine pass writes the f32 sum of its
// f32 workspace rows.  A bf16 gather moves half the bytes of an f32 one.
//
// Hopper features: none beyond vector loads, cache-streaming hints and
// warp shuffles.  The
// indices are loaded by the group's lanes together and broadcast by
// shuffles instead of staged in shared memory: a group's slots are
// contiguous, so the load is coalesced, and the next batch is in flight
// while the current one is gathered.  TMA and clusters have no work in
// a kernel whose every byte is a row gather at a data-dependent address.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;      // threads per block (both passes)
constexpr int kUnroll = 8;         // row gathers in flight per lane group
constexpr int kGroupSlots = 64;    // slots per lane group in narrow buckets
constexpr int kMaxBuckets = 32;
constexpr int kRowBlocksPerSM = 3;  // row-pass blocks per SM (<= 80 registers)
constexpr int kCombineUnroll = 16;  // workspace rows in flight (combine pass)
constexpr bool kStreamStores = true;  // out and workspace stored evict-first

struct Buckets {
  int n;
  int k[kMaxBuckets];                   // slots per virtual row
  int rpg[kMaxBuckets];                 // rows per lane group
  long long rows[kMaxBuckets];          // virtual rows
  long long slot0[kMaxBuckets];         // first slot
  long long vrow0[kMaxBuckets];         // first virtual row
  long long block0[kMaxBuckets];        // first block
  long long blocks[kMaxBuckets];        // blocks
};

// a slot weight as the term uses it: as stored for f32 x, rounded to
// bf16 for bf16 x (w.astype(x.dtype))
template <typename T>
__device__ __forceinline__ float slot_weight(float w) {
  if constexpr (sizeof(T) == 2) return rows::bf16_rn(w);
  return w;
}

__device__ __forceinline__ unsigned group_mask(int L) {
  const int lane = threadIdx.x & 31;
  return L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane / L * L);
}

// T: the element type of x and out (float or __nv_bfloat16); VEC: the
// elements of one lane's loads and stores; the workspace is f32
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kRowBlocksPerSM)
ell_row_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
               const float* __restrict__ w, const int32_t* __restrict__ vdst,
               T* __restrict__ out, float* __restrict__ ws,
               const Buckets bk, int d, int L) {
  int b = 0;  // the bucket whose blocks hold this one
  while (b + 1 < bk.n && !((long long)blockIdx.x >= bk.block0[b] &&
                           (long long)blockIdx.x < bk.block0[b] + bk.blocks[b]))
    ++b;
  const int K = bk.k[b];
  const int rpg = bk.rpg[b];
  const int groups = kThreads / L;
  const int group = threadIdx.x / L;
  const int sub = threadIdx.x % L;
  const long long r0 =
      ((long long)blockIdx.x - bk.block0[b]) * groups * rpg +
      (long long)group * rpg;
  if (r0 >= bk.rows[b]) return;  // group-uniform
  const long long r1 = min(r0 + rpg, bk.rows[b]);
  const long long a = bk.slot0[b] + r0 * K;    // the group's first slot
  const int n = (int)((r1 - r0) * K);          // its slots (<= 256)
  const unsigned gmask = group_mask(L);
  const int32_t* rdst = vdst + bk.vrow0[b] + r0;

  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int col = c0 + sub * VEC;
    const bool active = col < d;  // d % VEC == 0: the whole vector is in
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    int row = 0;       // the group's row being summed
    int left = K;      // its slots still to add
    int32_t ci = sub < n ? __ldcs(idx + a + sub) : 0;
    float cw = sub < n ? slot_weight<T>(__ldcs(w + a + sub)) : 0.f;
    for (int e0 = 0; e0 < n; e0 += L) {
      const int m = min(L, n - e0);
      // the next L slots, in flight while these are gathered
      const int nx = e0 + L + sub;
      const int32_t ni = nx < n ? __ldcs(idx + a + nx) : 0;
      const float nw = nx < n ? slot_weight<T>(__ldcs(w + a + nx)) : 0.f;
      for (int u0 = 0; u0 < m; u0 += kUnroll) {
        rows::Piece<T, VEC> v[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(gmask, ci, (u0 + u) % L, L);
          wt[u] = __shfl_sync(gmask, cw, (u0 + u) % L, L);
          if (active && u0 + u < m) {
            v[u].ldg(x + (long long)s * d + col);
          } else {
            v[u].zero();
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u0 + u < m) {  // group-uniform
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] += wt[u] * v[u].get(q);
            if (--left == 0) {  // the row is complete
              const int t = __ldcs(rdst + row);
              if (active) {
                if constexpr (sizeof(T) == 4) {
                  // one store through a selected pointer: two stores
                  // in two branches cost the f32 row pass its register
                  // budget (32 bytes of spills, 7 % of its time on an
                  // H100 at the LightGCN slice shape)
                  float* o = t >= 0
                                 ? reinterpret_cast<float*>(out) +
                                       (long long)t * d
                                 : ws + (long long)(-1 - t) * d;
                  rows::store_f32<float, VEC>(o + col, acc, kStreamStores);
                } else if (t >= 0) {  // bf16 out, f32 workspace
                  rows::store_f32<T, VEC>(out + (long long)t * d + col, acc,
                                          kStreamStores);
                } else {
                  rows::store_f32<float, VEC>(
                      ws + (long long)(-1 - t) * d + col, acc, kStreamStores);
                }
              }
#pragma unroll
              for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
              ++row;
              left = K;
            }
          }
        }
      }
      ci = ni;
      cw = nw;
    }
  }
}

// each remaining node once: the sum of its workspace rows in row order
// (a split node), or 0 (an isolated node: no rows); f32 workspace rows
// in, T out
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ell_combine_kernel(const float* __restrict__ ws,
                   const int32_t* __restrict__ rest_node,
                   const int32_t* __restrict__ rest_start,
                   const int32_t* __restrict__ rest_count,
                   T* __restrict__ out, long long n_rest, int d, int L) {
  // loads in flight: fewer for the 8-wide pieces of bf16 rows, whose
  // f32 workspace pieces are twice as many registers
  constexpr int U = VEC > 4 ? kCombineUnroll / 2 : kCombineUnroll;
  const long long j =
      (long long)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  if (j >= n_rest) return;
  const int sub = threadIdx.x % L;
  const long long node = rest_node[j];
  const float* p = ws + (long long)rest_start[j] * d;
  const int cnt = rest_count[j];
  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int col = c0 + sub * VEC;
    if (col >= d) break;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    int r = 0;
    // U loads issued together, added in row order
    for (; r + U <= cnt; r += U) {
      rows::Piece<float, VEC> v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u].ldg(p + (long long)(r + u) * d + col);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] += v[u].get(q);
    }
    for (; r < cnt; ++r) {
      rows::Piece<float, VEC> v;
      v.ldg(p + (long long)r * d + col);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] += v.get(q);
    }
    rows::store_f32<T, VEC>(out + node * d + col, acc, kStreamStores);
  }
}

int lanes_for(int d, int vec) {
  const int need = (d + vec - 1) / vec;
  int L = 1;
  while (L < need && L < 32) L <<= 1;
  return L;
}

template <typename T, int VEC>
int launch(const void* x, const int32_t* idx, const float* w,
           const int32_t* vdst, void* out, float* ws,
           const int32_t* rest_node, const int32_t* rest_start,
           const int32_t* rest_count, long long n_rest, const Buckets& bk,
           long long n_blocks, int d, int L, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (n_blocks > 0) {
    ell_row_kernel<T, VEC><<<(unsigned)n_blocks, kThreads, 0, st>>>(
        xp, idx, w, vdst, op, ws, bk, d, L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_rest > 0) {
    const long long per_block = kThreads / L;
    const long long blocks = (n_rest + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    ell_combine_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, st>>>(
        ws, rest_node, rest_start, rest_count, op, n_rest, d, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_in, d) and out (n_nodes, d), both f32 (bf16 == 0) or both bf16
// (bf16 == 1); idx / w (E_pad,) int32 / f32, the buckets' slots one
// bucket after another, each row-major (rows[b], ks[b]); vdst
// (n_vrows,) int32; ws (>= the split nodes' virtual rows, d) f32
// scratch; rest_node / rest_start / rest_count (n_rest,) int32.  ks and
// rows are HOST arrays of n_buckets (<= 32) entries.  vec: the elements
// of each x/out/ws access (f32: 1, 2 or 4; bf16: 1, 2, 4 or 8; d % vec
// == 0, x and out aligned to vec elements).  Launches the row pass and,
// if n_rest > 0, the combine pass on `stream`; returns a cudaError_t.
extern "C" int ell_spmm_launch(const void* x, const void* idx, const void* w,
                               const void* vdst, void* out, void* ws,
                               const void* rest_node, const void* rest_start,
                               const void* rest_count, long long n_rest,
                               const long long* ks, const long long* rows,
                               int n_buckets, int d, int vec, int bf16,
                               void* stream) {
  const int max_vec = bf16 ? 8 : 4;
  if (n_buckets < 0 || n_buckets > kMaxBuckets || n_rest < 0 || d <= 0 ||
      vec < 1 || vec > max_vec || (vec & (vec - 1)) != 0 || d % vec != 0 ||
      (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  const int L = lanes_for(d, vec);
  const long long groups = kThreads / L;
  Buckets bk;
  bk.n = n_buckets;
  long long slot = 0, vrow = 0;
  for (int b = 0; b < n_buckets; ++b) {
    if (ks[b] <= 0 || ks[b] > 4096 || rows[b] < 0)
      return (int)cudaErrorInvalidValue;
    bk.k[b] = (int)ks[b];
    bk.rpg[b] = ks[b] >= kGroupSlots ? 1 : (int)(kGroupSlots / ks[b]);
    bk.rows[b] = rows[b];
    bk.slot0[b] = slot;
    bk.vrow0[b] = vrow;
    bk.blocks[b] = (rows[b] + groups * bk.rpg[b] - 1) / (groups * bk.rpg[b]);
    slot += rows[b] * ks[b];
    vrow += rows[b];
  }
  // the widest buckets' blocks first: the longest blocks start first
  long long n_blocks = 0;
  for (int b = n_buckets - 1; b >= 0; --b) {
    bk.block0[b] = n_blocks;
    n_blocks += bk.blocks[b];
  }
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* wp = static_cast<const float*>(w);
  const int32_t* vp = static_cast<const int32_t*>(vdst);
  float* sp = static_cast<float*>(ws);
  const int32_t* rn = static_cast<const int32_t*>(rest_node);
  const int32_t* rs = static_cast<const int32_t*>(rest_start);
  const int32_t* rc = static_cast<const int32_t*>(rest_count);
#define ELL_LAUNCH(T, V)                                                    \
  launch<T, V>(x, ip, wp, vp, out, sp, rn, rs, rc, n_rest, bk, n_blocks, d, \
               L, st)
  if (bf16) {
    switch (vec) {
      case 8: return ELL_LAUNCH(__nv_bfloat16, 8);
      case 4: return ELL_LAUNCH(__nv_bfloat16, 4);
      case 2: return ELL_LAUNCH(__nv_bfloat16, 2);
      default: return ELL_LAUNCH(__nv_bfloat16, 1);
    }
  }
  switch (vec) {
    case 4: return ELL_LAUNCH(float, 4);
    case 2: return ELL_LAUNCH(float, 2);
    default: return ELL_LAUNCH(float, 1);
  }
#undef ELL_LAUNCH
}
