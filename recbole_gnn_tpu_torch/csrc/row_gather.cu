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
// Any element type: the kernel copies bytes, in units of U = 2, 4, 8 or
// 16 bytes (the widest that the row's bytes and the addresses allow), so
// a bf16 x (activation_dtype: bfloat16) is gathered as bf16 rows, bit
// for bit what index_select gives, at half the bytes of an f32 row.  An
// f32 row takes the units it took before (VEC floats = one unit).
//
// Precondition (checked by nobody on the card, as for an index_select
// without bounds checks): 0 <= idx[j] < rows of x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // rows in flight per lane group

// rows of d units of type U (unsigned short, unsigned int, uint2, uint4)
template <typename U>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const U* __restrict__ x, const int32_t* __restrict__ idx,
                  U* __restrict__ out, int64_t n_out, int d, int L) {
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

  for (int c0 = 0; c0 < d; c0 += L) {
    const int col = c0 + sub;
    if (col >= d) break;
    U v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n_here) v[u] = __ldg(x + row_off[u] + col);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n_here) out[(first + u) * (int64_t)d + col] = v[u];
  }
}

int lanes_for(int d) {
  int L = 1;
  while (L < d && L < 32) L <<= 1;
  return L;
}

template <typename U>
int launch(const void* x, const int32_t* idx, void* out, long long n_out,
           int d, cudaStream_t st) {
  const int L = lanes_for(d);
  const long long groups = (n_out + kUnroll - 1) / kUnroll;
  const long long blocks = (groups * L + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<U><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const U*>(x), idx, static_cast<U*>(out), n_out, d, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_in, row_bytes / elem) and out (n_out, same) of any element type,
// idx (n_out,) int32.  unit: the bytes of each access (2, 4, 8 or 16;
// row_bytes % unit == 0, x and out aligned to unit bytes).  Launches on
// `stream`; returns a cudaError_t.
extern "C" int row_gather_launch(const void* x, const void* idx, void* out,
                                 long long n_out, long long row_bytes,
                                 int unit, void* stream) {
  if (n_out < 0 || row_bytes <= 0 ||
      (unit != 2 && unit != 4 && unit != 8 && unit != 16) ||
      row_bytes % unit != 0 || row_bytes / unit > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  const int d = (int)(row_bytes / unit);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch<uint4>(x, ip, out, n_out, d, st);
    case 8: return launch<uint2>(x, ip, out, n_out, d, st);
    case 4: return launch<unsigned int>(x, ip, out, n_out, d, st);
    default: return launch<unsigned short>(x, ip, out, n_out, d, st);
  }
}
