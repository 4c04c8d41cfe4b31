// Row-vector loads, stores and message arithmetic shared by the segment-sum
// kernels (segment_spmm.cu, gat_mix.cu), for float32 and bfloat16 data.
//
//   * load_vec<T, VEC>: VEC consecutive elements (16, 8, 4 or 2 bytes at a
//     time, or one), widened to float32;
//   * store_vec<T, VEC>: VEC float32 sums stored as T, each rounded once
//     (round to nearest even) for bf16;
//   * Msg<T>: one message w * x added to a float32 sum. float32 takes one
//     FMA; bf16 forms the message as XLA's bf16 multiply does, the product
//     of two bf16 values (exact in float32) rounded to bf16, then adds it in
//     float32.
//
// The caller guarantees the alignment of each vector (VEC * sizeof(T)
// bytes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pgt {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v);

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* __restrict__ p,
                                                   float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

template <>
__device__ __forceinline__ void load_vec<float, 2>(const float* __restrict__ p,
                                                   float* v) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* __restrict__ p,
                                                   float* v) {
  v[0] = __ldg(p);
}

// n bf16 pairs packed in 32-bit words, widened
template <int N>
__device__ __forceinline__ void unpack_bf16(const uint32_t* w, float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + i));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(
    const __nv_bfloat16* __restrict__ p, float* v) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
  unpack_bf16<4>(w, v);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* __restrict__ p, float* v) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const uint32_t w[2] = {t.x, t.y};
  unpack_bf16<2>(w, v);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(
    const __nv_bfloat16* __restrict__ p, float* v) {
  const uint32_t w[1] = {__ldg(reinterpret_cast<const unsigned int*>(p))};
  unpack_bf16<1>(w, v);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* __restrict__ p, float* v) {
  v[0] = __bfloat162float(p[0]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* acc);

template <>
__device__ __forceinline__ void store_vec<float, 4>(float* __restrict__ p,
                                                    const float* acc) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <>
__device__ __forceinline__ void store_vec<float, 2>(float* __restrict__ p,
                                                    const float* acc) {
  *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
}

template <>
__device__ __forceinline__ void store_vec<float, 1>(float* __restrict__ p,
                                                    const float* acc) {
  *p = acc[0];
}

// two float32 values rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 8>(
    __nv_bfloat16* __restrict__ p, const float* acc) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                 pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 4>(
    __nv_bfloat16* __restrict__ p, const float* acc) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]));
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 2>(
    __nv_bfloat16* __restrict__ p, const float* acc) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[0], acc[1]);
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(
    __nv_bfloat16* __restrict__ p, const float* acc) {
  *p = __float2bfloat16_rn(acc[0]);
}

template <typename T>
struct Msg;

template <>
struct Msg<float> {
  // w * x + acc in one rounding, as the float32 kernels always did
  static __device__ __forceinline__ float add(float acc, float wk, float xv,
                                              bool) {
    return fmaf(wk, xv, acc);
  }
};

template <>
struct Msg<__nv_bfloat16> {
  // bf16(w * x), then the float32 sum; x itself when there is no weight
  static __device__ __forceinline__ float add(float acc, float wk, float xv,
                                              bool weighted) {
    return acc + (weighted ? __bfloat162float(__float2bfloat16_rn(wk * xv))
                           : xv);
  }
};

}  // namespace pgt
