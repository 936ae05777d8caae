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
// segment_spmm_transpose launches it that way.  The symmetric
// LightGCN adjacency gives the transpose the same long rows.
// The TPU kernel materialised a (segment, D) message stream in
// HBM, scanned it in <= 2^20-edge segments and reduced each chunk with
// a one-hot matrix product; none of that is needed here.  This kernel
// gathers x[src] itself, so one launch covers the whole padded edge
// list, and every output row has exactly one owner, so there are no
// atomics and the result is the same bit for bit from run to run.
//
// What bounds it on H100: memory.  Per edge it reads 8 bytes of index
// and weight and one D-float row of x, for 2*D flops, far below the
// card's ~20 flop/byte balance point for fp32.  At the LightGCN slice
// shape the 18 MB x table fits in the 50 MB L2, so the DRAM traffic
// the work needs is indices + weights + one read of x + one write of
// out.  The design keeps every byte it moves useful: vector loads of
// whole x rows (8 or 16 bytes a lane), coalesced index loads (32 edges
// a warp, broadcast by shuffles) and one store per output element.
//
// Layout: one warp per destination row.  The D columns are split over
// L lanes (L a power of two, L*VEC >= min(D, 32*VEC)); the 32/L lane
// groups of a warp walk different edges of the row at once and are
// summed by shuffles at the end.  D wider than 32*VEC takes several
// passes over the row's edges.  Rows with no edges (the PAD id 0, any
// node without interactions) are written as zeros.
//
// Known weakness, and what sets the time today: a long row (a
// Zipf-popular item, or the weight-0 padding tail on the last row) is
// walked by a single warp, so the launch lasts as long as that warp's
// chain of gathers.  Each lane keeps kUnroll gathers in flight to
// shorten it; splitting long rows over several warps is the redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// gathers in flight per lane: a warp issues kUnroll row loads before
// it consumes the first, so a long row is not walked one load latency
// per edge
constexpr int kUnroll = 8;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(float* v, const float* p) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* acc) { p[0] = acc[0]; }
};
template <>
struct Vec<2> {
  __device__ static void load(float* v, const float* p) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(float* p, const float* acc) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void load(float* v, const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_spmm_kernel(const float* __restrict__ x,
                    const int32_t* __restrict__ src,
                    const float* __restrict__ w,
                    const int64_t* __restrict__ rowptr,
                    float* __restrict__ out,
                    int64_t n_rows, int d, int lanes_per_edge) {
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int L = lanes_per_edge;
  const int groups = 32 / L;
  const int group = lane / L;
  const int sub = lane % L;
  const int64_t beg = rowptr[row];
  const int64_t end = rowptr[row + 1];

  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int col = c0 + sub * VEC;
    const bool active = col < d;  // d % VEC == 0: the whole vector is in
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

    for (int64_t e0 = beg; e0 < end; e0 += 32) {
      // coalesced: lane j holds edge e0 + j
      int32_t s = 0;
      float wt = 0.f;
      if (e0 + lane < end) {
        s = src[e0 + lane];
        wt = w[e0 + lane];
      }
      const int n_here = (int)((end - e0) < 32 ? (end - e0) : 32);
      for (int base = 0; base < n_here; base += kUnroll * groups) {
        // edge jj of the batch goes to lane group jj % groups; a slot
        // past the batch (jj >= n_here) loads nothing and adds 0
        float v[kUnroll][VEC];
        float wu[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = base + u * groups + group;
          const int32_t sj = __shfl_sync(kFull, s, jj & 31);
          const float wj = __shfl_sync(kFull, wt, jj & 31);
          const bool edge = jj < n_here;
          wu[u] = edge ? wj : 0.f;
          if (active && edge) {
            Vec<VEC>::load(v[u], x + (int64_t)sj * d + col);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
          }
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += wu[u] * v[u][k];
        }
      }
    }
    // sum the lane groups that walked different edges of this row
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    if (group == 0 && active) {
      Vec<VEC>::store(out + row * (int64_t)d + col, acc);
    }
  }
}

int lanes_for(int d, int vec) {
  int need = (d + vec - 1) / vec;
  int L = 1;
  while (L < need && L < 32) L <<= 1;
  return L;
}

}  // namespace

extern "C" int segment_spmm_f32(const void* x, const void* src,
                                const void* w, const void* rowptr,
                                void* out, long long n_rows, int d, int vec,
                                void* stream) {
  if (n_rows < 0 || d <= 0 || (vec != 1 && vec != 2 && vec != 4) ||
      d % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int L = lanes_for(d, vec);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const float* wp = static_cast<const float*>(w);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  float* op = static_cast<float*>(out);
  switch (vec) {
    case 4:
      segment_spmm_kernel<4><<<grid, block, 0, st>>>(xp, sp, wp, rp, op,
                                                     n_rows, d, L);
      break;
    case 2:
      segment_spmm_kernel<2><<<grid, block, 0, st>>>(xp, sp, wp, rp, op,
                                                     n_rows, d, L);
      break;
    default:
      segment_spmm_kernel<1><<<grid, block, 0, st>>>(xp, sp, wp, rp, op,
                                                     n_rows, d, L);
  }
  return (int)cudaGetLastError();
}
