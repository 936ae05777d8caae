// Row gather, for NVIDIA Hopper (sm_90a).
//
//   out[j, :] = x[idx[j], :]        j in [0, n_out)
//
// Replaces scripts/diag/r3_sparse_probe4.py::case_q.kernel, the Pallas
// row-DMA gather (one HBM->VMEM copy of one row per output row, 8
// copies in flight, C = 2048 rows per program, idx in SMEM).  In the
// port it is also the gather half of sparse_spmm_impl: xla
// (recbole_gnn_tpu/ops/spmm.py::spmm_coo, msgs = x[src]), forward and
// backward, launched by ops/gather.py::row_gather.
//
// What bounds it on H100: memory.  It does no arithmetic; it reads the
// int32 index once, each distinct row of x at least once, and writes
// n_out rows once.  The output is the largest stream (n_out * D * 4
// bytes: 1 GB at the probe's shape, 436 MB at the LightGCN slice's), so
// the design keeps every store coalesced and wide, and keeps enough
// row loads in flight to cover the DRAM latency.
//
// Layout: a group of L lanes (L a power of two, L*VEC >= min(D,
// 32*VEC)) copies a row with VEC-float vector loads and stores (16 or 8
// bytes a lane where D and the alignment allow).  Each group owns
// kUnroll consecutive output rows and issues all of their loads before
// it stores the first, the counterpart of the probe's 8 DMAs in
// flight; consecutive groups own consecutive rows, so a warp's stores
// cover contiguous memory.  D wider than L*VEC takes several passes.
// No shared memory, no atomics: every output element has one writer.
//
// Precondition (checked by nobody on the card, as for an index_select
// without bounds checks): 0 <= idx[j] < rows of x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // rows in flight per lane group

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(float* v, const float* p) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { p[0] = v[0]; }
};
template <>
struct Vec<2> {
  __device__ static void load(float* v, const float* p) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
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
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ x,
                  const int32_t* __restrict__ idx,
                  float* __restrict__ out, int64_t n_out, int d, int L) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t group = t / L;
  const int sub = (int)(t % L);
  const int64_t first = group * kUnroll;
  if (first >= n_out) return;  // no shuffles below: divergence is fine
  const int n_here =
      (int)((n_out - first) < kUnroll ? (n_out - first) : kUnroll);

  // the group's lanes read the same kUnroll indices: one transaction
  int64_t row_off[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    row_off[u] = u < n_here ? (int64_t)__ldg(idx + first + u) * d : 0;

  for (int c0 = 0; c0 < d; c0 += L * VEC) {
    const int col = c0 + sub * VEC;
    if (col >= d) break;  // d % VEC == 0: the whole vector is in
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n_here) Vec<VEC>::load(v[u], x + row_off[u] + col);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n_here)
        Vec<VEC>::store(out + (first + u) * (int64_t)d + col, v[u]);
  }
}

int lanes_for(int d, int vec) {
  const int need = (d + vec - 1) / vec;
  int L = 1;
  while (L < need && L < 32) L <<= 1;
  return L;
}

}  // namespace

extern "C" int row_gather_f32(const void* x, const void* idx, void* out,
                              long long n_out, int d, int vec, void* stream) {
  if (n_out < 0 || d <= 0 || (vec != 1 && vec != 2 && vec != 4) ||
      d % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  const int L = lanes_for(d, vec);
  const long long groups = (n_out + kUnroll - 1) / kUnroll;
  const long long blocks = (groups * L + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  switch (vec) {
    case 4:
      row_gather_kernel<4><<<grid, block, 0, st>>>(xp, ip, op, n_out, d, L);
      break;
    case 2:
      row_gather_kernel<2><<<grid, block, 0, st>>>(xp, ip, op, n_out, d, L);
      break;
    default:
      row_gather_kernel<1><<<grid, block, 0, st>>>(xp, ip, op, n_out, d, L);
  }
  return (int)cudaGetLastError();
}
