// Multi-head softmax mix over a destination-sorted CSC, for Hopper (sm_90a),
// float32 (`pgt_gat_mix_f32`) and bfloat16 (`pgt_gat_mix_bf16`):
//
//   s[d, h]    = sum_{k = indptr[d]}^{indptr[d+1]-1} p_s[k, h]
//   u[d, h, :] = sum_{k = indptr[d]}^{indptr[d+1]-1} p_u[k, h] * v[src[k], h, :]
//
// Replaces the TPU kernel `_chunk_kernel` (pytorch_geometric_tpu/ops/
// pallas_spmm.py:74) at its second launch site (:212, `segment_sum_blocked`)
// in its per-head form: the softmax numerator and denominator of
// `gat_fused._gat_mix` (ops/gat_fused.py:80), the stabiliser sum of
// `gat_aggregate` (:161, `v` absent, `s` only) and `grad_v` of
// `_gat_mix_bwd` over the source-major layout (:111, `p_s` absent, `u`
// only). The TPU builds the `[E, H + H*F]` message array `[p_s | p_u * v[src]]`
// in device memory and reduces it with one-hot matmuls on the MXU; here each
// message is formed in registers and never written, and `s` and `u` are
// separate outputs so that every `u` row starts 16-byte aligned.
//
//   * a group of LANES lanes of one warp owns one destination row (LANES = 32
//     once a row has 32 vector columns, fewer for narrow rows, so one warp
//     serves several rows); each lane strides the H*F columns VEC floats at
//     a time, and a vector never straddles two heads (F % VEC == 0);
//   * the f32 accumulators stay in registers for the whole edge run and each
//     output row is written once, zeros for an empty row;
//   * no atomics: every sum is taken in CSC order, so the result is
//     deterministic;
//   * `s` counts every slot of the row; `u` skips a slot whose source lies
//     outside [0, n_src), as the JAX package masks `v[src]`; the padded slots
//     past indptr[n_dst] are never read, and a row's run is clamped to
//     [0, n_edges), so a malformed indptr reads nothing out of bounds.
//
// Bound on the card: bytes. The least traffic is v, p_s, p_u, src, indptr,
// s and u once each; the kernel gathers one H*F row of v per slot
// (E * H * F * 4 bytes), which comes from L2 when v fits in its 50 MB and
// from device memory when it does not. The edge loop is unrolled by four so
// that four independent row loads are in flight per lane.
//
// The bf16 arm takes p_s, p_u and v all bf16 (what `_gat_mix` feeds the
// kernel when all three are bf16, ops/gat_fused.py:76-81, whose messages
// `p_u * v[src]` XLA forms in bf16): each message is bf16(p_u * v), the
// sums run in float32 and s and u are rounded to bf16 once, on the store.
//
// Plain C interface, bound from Python with ctypes; every launch returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec.cuh"

namespace {

using pgt::load_vec;
using pgt::Msg;
using pgt::store_vec;
using pgt::to_float;

// One slot's message for this lane's columns: p_u[k, head] * v[src[k], col:]
// added to acc; nothing for an inactive lane or a source out of range.
template <typename T, int VEC>
__device__ __forceinline__ void mix_slot(float* acc, const int* __restrict__ src,
                                         const T* __restrict__ p_u,
                                         const T* __restrict__ v, long long k,
                                         long long n_src, long long hf, int h,
                                         int head, long long col, bool active) {
  const int s = __ldg(src + k);
  if (!active || s < 0 || s >= n_src) return;
  const float w = to_float(p_u[k * h + head]);
  float t[VEC];
  load_vec<T, VEC>(v + (long long)s * hf + col, t);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = Msg<T>::add(acc[i], w, t[i], true);
}

constexpr int kThreads = 256;

template <typename T, int VEC, int LANES>
__global__ void __launch_bounds__(kThreads)
gat_mix_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
               const T* __restrict__ p_s, const T* __restrict__ p_u,
               const T* __restrict__ v, T* __restrict__ s_out,
               T* __restrict__ u_out, long long n_dst, long long n_src,
               long long n_edges, int h, int f) {
  constexpr int kRowsPerWarp = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long row = warp * kRowsPerWarp + lane / LANES;
  if (row >= n_dst) return;
  const int glane = lane % LANES;
  const long long beg =
      min(max((long long)__ldg(indptr + row), 0LL), n_edges);
  const long long end = min((long long)__ldg(indptr + row + 1), n_edges);

  if (s_out != nullptr) {
    for (int c = glane; c < h; c += LANES) {
      float acc = 0.f;
      for (long long k = beg; k < end; ++k) acc += to_float(p_s[k * h + c]);
      store_vec<T, 1>(s_out + row * h + c, &acc);
    }
  }
  if (u_out == nullptr) return;

  const long long hf = (long long)h * f;
  const long long fv = hf / VEC;  // vector columns in a row
  for (long long c0 = 0; c0 < fv; c0 += LANES) {
    const long long c = c0 + glane;
    const bool active = c < fv;
    const long long col = c * VEC;
    const int head = active ? (int)(col / f) : 0;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

    long long k = beg;
    for (; k + 4 <= end; k += 4) {
      mix_slot<T, VEC>(acc, src, p_u, v, k, n_src, hf, h, head, col, active);
      mix_slot<T, VEC>(acc, src, p_u, v, k + 1, n_src, hf, h, head, col,
                       active);
      mix_slot<T, VEC>(acc, src, p_u, v, k + 2, n_src, hf, h, head, col,
                       active);
      mix_slot<T, VEC>(acc, src, p_u, v, k + 3, n_src, hf, h, head, col,
                       active);
    }
    for (; k < end; ++k)
      mix_slot<T, VEC>(acc, src, p_u, v, k, n_src, hf, h, head, col, active);
    if (active) store_vec<T, VEC>(u_out + row * hf + col, acc);
  }
}

template <typename T, int VEC, int LANES>
cudaError_t launch(const int* indptr, const int* src, const T* p_s,
                   const T* p_u, const T* v, T* s_out, T* u_out,
                   long long n_dst, long long n_src, long long n_edges, int h,
                   int f, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = (kThreads / 32) * (32 / LANES);
  const long long blocks = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  gat_mix_kernel<T, VEC, LANES><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indptr, src, p_s, p_u, v, s_out, u_out, n_dst, n_src, n_edges, h, f);
  return cudaGetLastError();
}

// Lanes per row: the smallest power of two that covers the row's widest
// pass (the vector columns of u, or the H heads of s), at most a warp.
template <typename T, int VEC>
cudaError_t dispatch(long long width, const int* indptr, const int* src,
                     const T* p_s, const T* p_u, const T* v, T* s_out,
                     T* u_out, long long n_dst, long long n_src,
                     long long n_edges, int h, int f, cudaStream_t stream) {
#define PGT_LAUNCH(L)                                                      \
  return launch<T, VEC, L>(indptr, src, p_s, p_u, v, s_out, u_out, n_dst, \
                           n_src, n_edges, h, f, stream)
  if (width <= 1) PGT_LAUNCH(1);
  if (width <= 2) PGT_LAUNCH(2);
  if (width <= 4) PGT_LAUNCH(4);
  if (width <= 8) PGT_LAUNCH(8);
  if (width <= 16) PGT_LAUNCH(16);
  PGT_LAUNCH(32);
#undef PGT_LAUNCH
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest vector (at most 16 bytes, in `vecs`, widest first) that F
// divides and v and u are aligned to; then the launch over the row's
// widest pass.
template <typename T>
cudaError_t run(const void* indptr, const void* src, const void* p_s,
                const void* p_u, const void* v, void* s_out, void* u_out,
                long long n_dst, long long n_src, long long n_edges, int h,
                int f, void* stream) {
  if (n_dst <= 0 || h <= 0 || (s_out == nullptr && u_out == nullptr))
    return cudaSuccess;
  if (u_out != nullptr && f <= 0) u_out = nullptr;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const T* ps = static_cast<const T*>(p_s);
  const T* pu = static_cast<const T*>(p_u);
  const T* vp = static_cast<const T*>(v);
  T* so = static_cast<T*>(s_out);
  T* uo = static_cast<T*>(u_out);
  const long long hs = so ? h : 0;
  const long long hf = uo ? (long long)h * f : 0;
  constexpr int kMax = 16 / (int)sizeof(T);  // 4 floats or 8 bf16
  auto fits = [&](int vec) {
    const int bytes = vec * (int)sizeof(T);
    return f % vec == 0 && aligned(vp, bytes) && aligned(uo, bytes);
  };
  auto go = [&](auto vec_tag) {
    constexpr int VEC = decltype(vec_tag)::value;
    const long long width = hf / VEC > hs ? hf / VEC : hs;
    return dispatch<T, VEC>(width, ip, sp, ps, pu, vp, so, uo, n_dst, n_src,
                            n_edges, h, f, st);
  };
  if (fits(kMax)) return go(std::integral_constant<int, kMax>());
  if (fits(kMax / 2)) return go(std::integral_constant<int, kMax / 2>());
  if (kMax / 4 > 1 && fits(kMax / 4))
    return go(std::integral_constant<int, (kMax / 4 > 1 ? kMax / 4 : 1)>());
  return go(std::integral_constant<int, 1>());
}

}  // namespace

// indptr [n_dst + 1] int32, src [n_edges] int32, p_s and p_u [n_edges, h]
// float32, v [n_src, h * f] float32, s_out [n_dst, h] and u_out
// [n_dst, h * f] float32, all row-major. p_s and s_out are both null (no s)
// or both set; v, p_u and u_out likewise (no u). Runs on `stream` and does
// not synchronise. Returns cudaGetLastError() after the launch.
extern "C" int pgt_gat_mix_f32(const void* indptr, const void* src,
                               const void* p_s, const void* p_u,
                               const void* v, void* s_out, void* u_out,
                               long long n_dst, long long n_src,
                               long long n_edges, int h, int f,
                               void* stream) {
  return (int)run<float>(indptr, src, p_s, p_u, v, s_out, u_out, n_dst,
                         n_src, n_edges, h, f, stream);
}

// The same with p_s, p_u, v, s_out and u_out all bfloat16: messages
// bf16(p_u * v), float32 sums, s and u rounded once.
extern "C" int pgt_gat_mix_bf16(const void* indptr, const void* src,
                                const void* p_s, const void* p_u,
                                const void* v, void* s_out, void* u_out,
                                long long n_dst, long long n_src,
                                long long n_edges, int h, int f,
                                void* stream) {
  return (int)run<__nv_bfloat16>(indptr, src, p_s, p_u, v, s_out, u_out,
                                 n_dst, n_src, n_edges, h, f, stream);
}
