// Typed row pieces for the port's kernels: VEC consecutive elements of
// one row, f32 or bf16, loaded as ONE vector of VEC * sizeof(T) bytes
// (2 to 32: 32 is two 16-byte loads) and kept in registers in their
// stored form, so a bf16 piece of 8 values takes the 4 registers of an
// f32 piece of 4.  Values are widened to f32 where they are used: a bf16
// is the top half of the f32 with the same value, so the widening is a
// shift, exact.  Stores narrow f32 sums to T, bf16 by round to nearest
// even (__float2bfloat16_rn), once per output element.
//
// Alignment: the caller picks VEC so that the row width is a multiple of
// VEC and every piece's address a multiple of VEC * sizeof(T) bytes
// (ops/cuda_build.py's vec_width, from the element size and the base
// address); a bf16 row at an odd offset gets VEC 1 (2-byte loads).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rows {

// BYTES of a row in 32-bit words (BYTES == 2: the low half of w[0])
template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  uint32_t w[1];
  __device__ void ldg(const void* p) {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
  __device__ void ld(const void* p) {
    w[0] = *static_cast<const unsigned short*>(p);
  }
  __device__ void st(void* p, bool) const {
    *static_cast<unsigned short*>(p) = (unsigned short)w[0];
  }
};
template <>
struct Raw<4> {
  uint32_t w[1];
  __device__ void ldg(const void* p) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  }
  __device__ void ld(const void* p) {
    w[0] = *static_cast<const unsigned int*>(p);
  }
  __device__ void st(void* p, bool cs) const {
    unsigned int* q = static_cast<unsigned int*>(p);
    if (cs) __stcs(q, w[0]); else *q = w[0];
  }
};
template <>
struct Raw<8> {
  uint32_t w[2];
  __device__ void ldg(const void* p) {
    const uint2 t = __ldg(static_cast<const uint2*>(p));
    w[0] = t.x;
    w[1] = t.y;
  }
  __device__ void ld(const void* p) {
    const uint2 t = *static_cast<const uint2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  }
  __device__ void st(void* p, bool cs) const {
    uint2* q = static_cast<uint2*>(p);
    const uint2 t = make_uint2(w[0], w[1]);
    if (cs) __stcs(q, t); else *q = t;
  }
};
template <>
struct Raw<16> {
  uint32_t w[4];
  __device__ void ldg(const void* p) {
    const uint4 t = __ldg(static_cast<const uint4*>(p));
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  }
  __device__ void ld(const void* p) {
    const uint4 t = *static_cast<const uint4*>(p);
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  }
  __device__ void st(void* p, bool cs) const {
    uint4* q = static_cast<uint4*>(p);
    const uint4 t = make_uint4(w[0], w[1], w[2], w[3]);
    if (cs) __stcs(q, t); else *q = t;
  }
};
template <>
struct Raw<32> {
  uint32_t w[8];
  __device__ void ldg(const void* p) {
    const uint4* q = static_cast<const uint4*>(p);
    const uint4 a = __ldg(q), b = __ldg(q + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  __device__ void ld(const void* p) {
    const uint4* q = static_cast<const uint4*>(p);
    const uint4 a = q[0], b = q[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  __device__ void st(void* p, bool cs) const {
    uint4* q = static_cast<uint4*>(p);
    const uint4 a = make_uint4(w[0], w[1], w[2], w[3]);
    const uint4 b = make_uint4(w[4], w[5], w[6], w[7]);
    if (cs) {
      __stcs(q, a);
      __stcs(q + 1, b);
    } else {
      q[0] = a;
      q[1] = b;
    }
  }
};

// VEC elements of type T (float or __nv_bfloat16) in their stored form
template <typename T, int VEC>
struct Piece {
  static_assert(sizeof(T) == 4 || sizeof(T) == 2, "f32 or bf16 rows");
  Raw<VEC * (int)sizeof(T)> r;
  // read-only data through the non-coherent cache (__ldg)
  __device__ void ldg(const T* p) { r.ldg(p); }
  // plain loads (shared memory, or data this launch writes)
  __device__ void ld(const T* p) { r.ld(p); }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(r.w) / 4); ++i) r.w[i] = 0u;
  }
  // element q (0 <= q < VEC) widened to f32
  __device__ float get(int q) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(r.w[q]);
    } else {
      const uint32_t w = r.w[q >> 1];
      return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
  // all VEC elements widened to f32
  __device__ void get_all(float* v) const {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = get(q);
  }
  // VEC f32 values narrowed to T (bf16: round to nearest even)
  __device__ void set_all(const float* v) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) r.w[q] = __float_as_uint(v[q]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; q += 2) {
        const uint32_t lo =
            __bfloat16_as_ushort(__float2bfloat16_rn(v[q]));
        const uint32_t hi =
            q + 1 < VEC ? __bfloat16_as_ushort(__float2bfloat16_rn(v[q + 1]))
                        : 0u;
        r.w[q >> 1] = lo | (hi << 16);
      }
    }
  }
  // store; cs: evict-first (__stcs) where the width allows it
  __device__ void st(T* p, bool cs = false) const { r.st(p, cs); }
};

// v[0..VEC) = the VEC elements at p, widened (read-only, __ldg)
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(float* v, const T* p) {
  Piece<T, VEC> t;
  t.ldg(p);
  t.get_all(v);
}

// the VEC f32 values v narrowed to T and stored at p
template <typename T, int VEC>
__device__ __forceinline__ void store_f32(T* p, const float* v,
                                          bool cs = false) {
  Piece<T, VEC> t;
  t.set_all(v);
  t.st(p, cs);
}

// f32 -> bf16 (round to nearest even) -> f32
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace rows
