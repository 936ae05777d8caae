// Block segment sum over dst-sorted message rows, for NVIDIA Hopper
// (sm_90a).
//
//   out[r, :] (+)= sum_{e in [rowptr[r], rowptr[r+1])} t(msgs[e, :])
//
// Replaces scripts/diag/pallas_floor.py::make_kernel, the Pallas probe
// of K1's body without its gather: one program per BM = 64-row block
// streams the dst-sorted message chunks of its edge range and sums
// them into a (BM, D) accumulator, in one of three modes.  In the port
// it is also the reduction half of sparse_spmm_impl: xla
// (recbole_gnn_tpu/ops/spmm.py::spmm_coo's sorted segment_sum, and
// _spmm_coo_chunked, which accumulates chunk sums into one output),
// forward and backward, launched by ops/segment_sum.py.
//
// Modes (the term t added per message element, always summed in f32):
//   0 f32     t(m) = m, the exact sum (the xla path)
//   1 bf16    t(m) = bf16(m) rounded to nearest even (the probe's
//             n_pass=1: one bf16 one-hot product)
//   2 hilo    t(m) = hi + lo, hi = bf16(m), lo = bf16(m - hi) (n_pass=2)
//   3 stream  the probe's n_pass=0 copy floor: the block reads every
//             EC-aligned chunk its edge range touches, and adds only
//             msgs[c*EC + r] to row r where r = dst[c*EC] - block base
//
// What bounds it on H100: memory.  Per edge it reads one D-float
// message row and one int32 dst and adds D floats; at 2 flops/16 bytes
// at most it is far below the card's fp32 balance point.  The bound is
// the message stream read once (513 MB at the probe's shape, 436 MB
// per SpMM at the LightGCN slice's) plus dst, the row pointer and the
// output.  The design streams each message byte once with wide loads
// (8 or 16 bytes a lane, a whole row per warp load), keeps kUnroll
// rows in flight per warp, and writes each output element once.
//
// Layout (modes 0-2): one CTA of kWarps warps per bm-row block.  The
// block's edge range [rowptr[base], rowptr[base + bm]) is cut into
// kWarps contiguous shares, one per warp, so a long (hub) row is
// walked by all the warps its edges span and not by one.  A warp walks
// its share edge by edge, lanes across a 32*VEC-column slab, keeping a
// running sum of the current row.  A row that starts and ends inside
// the share has one owner, which writes it into the block's shared
// (bm, 32*VEC) accumulator; the share's first and last rows may be
// shared with the neighbouring warps, so they go to per-warp carry
// slots, which one pass adds into the accumulator in warp order.
// There are no atomics: the sum order is fixed, and runs repeat bit
// for bit.  The accumulator is then written out once (out = acc, or
// out += acc when accumulating); rows without edges get 0 (or keep
// out).  D wider than the slab takes several passes.
//
// Layout (mode 3): one CTA per block stages the covered chunks through
// shared memory in kStageBytes tiles with cp.async, double-buffered,
// and adds the placeholder rows from the staged tiles, so its time is
// the stream's.
//
// Out of scope here (later work): TMA, warp specialisation, and
// splitting a hub block over several CTAs.  At the slice shape one
// block holds the 12,902-edge hub row; its kWarps warps share it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 8;          // message rows in flight per warp
constexpr int kStageBytes = 16384;  // one stream-mode tile buffer
constexpr int kMaxSmem = 232448;    // what a CTA may use on H100

enum Mode { kF32 = 0, kBf16 = 1, kHilo = 2, kStream = 3 };

template <int MODE>
__device__ __forceinline__ float term(float m) {
  if (MODE == kF32) return m;
  const float hi = __bfloat162float(__float2bfloat16_rn(m));
  if (MODE == kBf16) return hi;
  return hi + __bfloat162float(__float2bfloat16_rn(m - hi));  // exact in f32
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(float* v, const float* p) { v[0] = __ldg(p); }
};
template <>
struct Vec<2> {
  __device__ static void load(float* v, const float* p) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
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
};

// write the block's accumulated rows [0, rows) of one column slab
__device__ __forceinline__ void write_rows(const float* acc, int acc_w,
                                           float* out, int64_t base,
                                           int rows, int d, int c0,
                                           int accumulate) {
  for (int i = threadIdx.x; i < rows * acc_w; i += kThreads) {
    const int r = i / acc_w;
    const int c = c0 + i % acc_w;
    if (c < d) {
      float* o = out + (base + r) * (int64_t)d + c;
      *o = accumulate ? *o + acc[i] : acc[i];
    }
  }
}

template <int VEC, int MODE>
__global__ void __launch_bounds__(kThreads)
block_sum_kernel(const float* __restrict__ msgs,
                 const int32_t* __restrict__ dst,
                 const int64_t* __restrict__ rowptr,
                 float* __restrict__ out, int64_t n_rows, int d, int bm,
                 int accumulate) {
  constexpr int CW = 32 * VEC;  // columns per pass
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                      // [bm][CW]
  float* carry = smem + (size_t)bm * CW;  // [2 * kWarps][CW]
  __shared__ int carry_row[2 * kWarps];

  const int64_t base = (int64_t)blockIdx.x * bm;
  const int rows = (int)((n_rows - base) < bm ? (n_rows - base) : bm);
  const int64_t beg = rowptr[base];
  const int64_t n_e = rowptr[base + rows] - beg;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t share = (n_e + kWarps - 1) / kWarps;
  const int64_t p0 = beg + (warp * share < n_e ? warp * share : n_e);
  const int64_t p1 =
      beg + ((warp + 1) * share < n_e ? (warp + 1) * share : n_e);

  for (int c0 = 0; c0 < d; c0 += CW) {
    const int col = c0 + lane * VEC;
    const bool active = col < d;  // d % VEC == 0: the whole vector is in
    for (int i = threadIdx.x; i < bm * CW; i += kThreads) acc[i] = 0.f;
    if (threadIdx.x < 2 * kWarps) carry_row[threadIdx.x] = -1;
    __syncthreads();

    if (p0 < p1) {  // warp-uniform
      const int first = (int)(dst[p0] - base);
      int cur = first;
      float a[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = 0.f;
      for (int64_t e0 = p0; e0 < p1; e0 += 32) {
        const int n_here = (int)((p1 - e0) < 32 ? (p1 - e0) : 32);
        // coalesced: lane j holds the row of edge e0 + j
        const int r_lane = lane < n_here ? (int)(dst[e0 + lane] - base) : 0;
        for (int j0 = 0; j0 < n_here; j0 += kUnroll) {
          float v[kUnroll][VEC];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (active && j0 + u < n_here) {
              Vec<VEC>::load(v[u], msgs + (e0 + j0 + u) * (int64_t)d + col);
            } else {
#pragma unroll
              for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int r = __shfl_sync(kFull, r_lane, (j0 + u) & 31);
            if (j0 + u < n_here) {
              if (r != cur) {  // warp-uniform: row cur is complete
                if (cur == first) {
#pragma unroll
                  for (int k = 0; k < VEC; ++k)
                    carry[(2 * warp) * CW + lane * VEC + k] = a[k];
                  if (lane == 0) carry_row[2 * warp] = cur;
                } else if ((unsigned)cur < (unsigned)bm) {
                  // a row wholly inside this share: its one owner
#pragma unroll
                  for (int k = 0; k < VEC; ++k)
                    acc[cur * CW + lane * VEC + k] = a[k];
                }
                cur = r;
#pragma unroll
                for (int k = 0; k < VEC; ++k) a[k] = 0.f;
              }
#pragma unroll
              for (int k = 0; k < VEC; ++k) a[k] += term<MODE>(v[u][k]);
            }
          }
        }
      }
      // the share's last row (or its only one) may continue elsewhere
      const int slot = cur == first ? 2 * warp : 2 * warp + 1;
#pragma unroll
      for (int k = 0; k < VEC; ++k) carry[slot * CW + lane * VEC + k] = a[k];
      if (lane == 0) carry_row[slot] = cur;
    }
    __syncthreads();
    // carries into the accumulator, in warp order (deterministic)
    for (int i = threadIdx.x; i < CW; i += kThreads) {
      for (int s = 0; s < 2 * kWarps; ++s) {
        const int r = carry_row[s];
        if (r >= 0 && r < bm) acc[r * CW + i] += carry[s * CW + i];
      }
    }
    __syncthreads();
    write_rows(acc, CW, out, base, rows, d, c0, accumulate);
    __syncthreads();  // acc is zeroed again by the next pass
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// stage tile t of the covered range (rows [t0, t0 + n) of msgs) into buf
__device__ __forceinline__ void stage_tile(const float* msgs, int64_t t0,
                                           int64_t n, int d, float* buf) {
  const int64_t pieces = n * d / 4;  // 16-byte pieces; n * d % 4 == 0
  const float4* src = reinterpret_cast<const float4*>(msgs + t0 * d);
  float4* dstp = reinterpret_cast<float4*>(buf);
  for (int64_t p = threadIdx.x; p < pieces; p += kThreads)
    cp_async16(dstp + p, src + p);
}

__global__ void __launch_bounds__(kThreads)
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
  for (int i = threadIdx.x; i < bm * d; i += kThreads) acc[i] = 0.f;
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
      cp_async_wait_one();
      __syncthreads();    // tile t is in, from every thread's copies
      const int64_t t0 = g0 + t * tile_rows;
      const int64_t t1 = (g1 - t0) < tile_rows ? g1 : t0 + tile_rows;
      const float* buf = stage + (t & 1) * tile_floats;
      for (int64_t c = t0 / ec; c * ec < t1; ++c) {
        const int r = (int)(dst[c * ec] - base);  // the placeholder row
        const int64_t g = c * ec + r;
        if (r >= 0 && r < bm && g >= t0 && g < t1) {
          for (int k = threadIdx.x; k < d; k += kThreads)
            acc[r * d + k] += buf[(g - t0) * d + k];
        }
      }
      __syncthreads();    // buffer t & 1 is refilled at t + 2
    }
  }
  write_rows(acc, d, out, base, rows, d, 0, accumulate);
}

template <int VEC, int MODE>
int launch_sum(const float* m, const int32_t* dp, const int64_t* rp,
               float* op, long long n_rows, int d, int bm, int accumulate,
               unsigned grid, cudaStream_t st) {
  const size_t smem = (size_t)(bm + 2 * kWarps) * 32 * VEC * sizeof(float);
  if (smem + 2 * kWarps * sizeof(int) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_sum_kernel<VEC, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_sum_kernel<VEC, MODE><<<grid, kThreads, smem, st>>>(
      m, dp, rp, op, n_rows, d, bm, accumulate);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_mode(int mode, const float* m, const int32_t* dp,
                const int64_t* rp, float* op, long long n_rows, int d,
                int bm, int accumulate, unsigned grid, cudaStream_t st) {
  switch (mode) {
    case kF32:
      return launch_sum<VEC, kF32>(m, dp, rp, op, n_rows, d, bm, accumulate,
                                   grid, st);
    case kBf16:
      return launch_sum<VEC, kBf16>(m, dp, rp, op, n_rows, d, bm,
                                    accumulate, grid, st);
    default:
      return launch_sum<VEC, kHilo>(m, dp, rp, op, n_rows, d, bm,
                                    accumulate, grid, st);
  }
}

}  // namespace

// msgs (E, d) f32, dst (E,) int32 sorted, rowptr (n_rows + 1,) int64 its
// CSR row pointer, out (n_rows, d) f32.  vec: the float width of the
// message loads (1, 2 or 4; d % vec == 0, msgs aligned to 4 * vec
// bytes).  Stream mode needs E % ec == 0, ec % 4 == 0 and msgs 16-byte
// aligned.  Returns a cudaError_t.
extern "C" int block_segment_sum_f32(const void* msgs, const void* dst,
                                     const void* rowptr, void* out,
                                     long long n_rows, int d, int vec,
                                     int mode, int bm, int ec,
                                     int accumulate, void* stream) {
  if (n_rows < 0 || d <= 0 || bm <= 0 || mode < kF32 || mode > kStream ||
      (vec != 1 && vec != 2 && vec != 4) || d % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const long long blocks = (n_rows + bm - 1) / bm;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(msgs);
  const int32_t* dp = static_cast<const int32_t*>(dst);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  float* op = static_cast<float*>(out);
  if (mode == kStream) {
    if (ec <= 0 || ec % 4 != 0) return (int)cudaErrorInvalidValue;
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
    block_stream_kernel<<<grid, kThreads, smem, st>>>(
        m, dp, rp, op, n_rows, d, bm, ec, tile_rows, accumulate);
    return (int)cudaGetLastError();
  }
  switch (vec) {
    case 4:
      return launch_mode<4>(mode, m, dp, rp, op, n_rows, d, bm, accumulate,
                            grid, st);
    case 2:
      return launch_mode<2>(mode, m, dp, rp, op, n_rows, d, bm, accumulate,
                            grid, st);
    default:
      return launch_mode<1>(mode, m, dp, rp, op, n_rows, d, bm, accumulate,
                            grid, st);
  }
}
