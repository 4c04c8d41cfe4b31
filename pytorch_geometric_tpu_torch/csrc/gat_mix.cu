// Multi-head softmax mix over a destination-sorted CSC, float32, for Hopper
// (sm_90a):
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
// Plain C interface, bound from Python with ctypes; every launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* __restrict__ p);

template <>
__device__ __forceinline__ Vec<4> load_vec<4>(const float* __restrict__ p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  Vec<4> r;
  r.v[0] = t.x;
  r.v[1] = t.y;
  r.v[2] = t.z;
  r.v[3] = t.w;
  return r;
}

template <>
__device__ __forceinline__ Vec<2> load_vec<2>(const float* __restrict__ p) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  Vec<2> r;
  r.v[0] = t.x;
  r.v[1] = t.y;
  return r;
}

template <>
__device__ __forceinline__ Vec<1> load_vec<1>(const float* __restrict__ p) {
  Vec<1> r;
  r.v[0] = __ldg(p);
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* acc);

template <>
__device__ __forceinline__ void store_vec<4>(float* __restrict__ p, const float* acc) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <>
__device__ __forceinline__ void store_vec<2>(float* __restrict__ p, const float* acc) {
  *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
}

template <>
__device__ __forceinline__ void store_vec<1>(float* __restrict__ p, const float* acc) {
  *p = acc[0];
}

// One slot's message for this lane's columns: p_u[k, head] * v[src[k], col:]
// accumulated into acc; nothing for an inactive lane or a source out of range.
template <int VEC>
__device__ __forceinline__ void mix_slot(float* acc, const int* __restrict__ src,
                                         const float* __restrict__ p_u,
                                         const float* __restrict__ v, long long k,
                                         long long n_src, long long hf, int h,
                                         int head, long long col, bool active) {
  const int s = __ldg(src + k);
  if (!active || s < 0 || s >= n_src) return;
  const float w = __ldg(p_u + k * h + head);
  const Vec<VEC> t = load_vec<VEC>(v + (long long)s * hf + col);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, t.v[i], acc[i]);
}

constexpr int kThreads = 256;

template <int VEC, int LANES>
__global__ void __launch_bounds__(kThreads)
gat_mix_f32_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
                   const float* __restrict__ p_s, const float* __restrict__ p_u,
                   const float* __restrict__ v, float* __restrict__ s_out,
                   float* __restrict__ u_out, long long n_dst, long long n_src,
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
      for (long long k = beg; k < end; ++k) acc += __ldg(p_s + k * h + c);
      s_out[row * h + c] = acc;
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
      mix_slot<VEC>(acc, src, p_u, v, k, n_src, hf, h, head, col, active);
      mix_slot<VEC>(acc, src, p_u, v, k + 1, n_src, hf, h, head, col, active);
      mix_slot<VEC>(acc, src, p_u, v, k + 2, n_src, hf, h, head, col, active);
      mix_slot<VEC>(acc, src, p_u, v, k + 3, n_src, hf, h, head, col, active);
    }
    for (; k < end; ++k)
      mix_slot<VEC>(acc, src, p_u, v, k, n_src, hf, h, head, col, active);
    if (active) store_vec<VEC>(u_out + row * hf + col, acc);
  }
}

template <int VEC, int LANES>
cudaError_t launch(const int* indptr, const int* src, const float* p_s,
                   const float* p_u, const float* v, float* s_out,
                   float* u_out, long long n_dst, long long n_src,
                   long long n_edges, int h, int f, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = (kThreads / 32) * (32 / LANES);
  const long long blocks = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  gat_mix_f32_kernel<VEC, LANES><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indptr, src, p_s, p_u, v, s_out, u_out, n_dst, n_src, n_edges, h, f);
  return cudaGetLastError();
}

// Lanes per row: the smallest power of two that covers the row's widest
// pass (the vector columns of u, or the H heads of s), at most a warp.
template <int VEC>
cudaError_t dispatch(long long width, const int* indptr, const int* src,
                     const float* p_s, const float* p_u, const float* v,
                     float* s_out, float* u_out, long long n_dst,
                     long long n_src, long long n_edges, int h, int f,
                     cudaStream_t stream) {
#define PGT_LAUNCH(L)                                                        \
  return launch<VEC, L>(indptr, src, p_s, p_u, v, s_out, u_out, n_dst, n_src, \
                        n_edges, h, f, stream)
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
  if (n_dst <= 0 || h <= 0 || (s_out == nullptr && u_out == nullptr))
    return (int)cudaSuccess;
  if (u_out != nullptr && f <= 0) u_out = nullptr;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const float* ps = static_cast<const float*>(p_s);
  const float* pu = static_cast<const float*>(p_u);
  const float* vp = static_cast<const float*>(v);
  float* so = static_cast<float*>(s_out);
  float* uo = static_cast<float*>(u_out);
  const long long hs = so ? h : 0;
  const long long hf = uo ? (long long)h * f : 0;
  // vector loads need F a multiple of the vector (so none straddles two
  // heads or two rows) and v and u aligned to it; else narrower ones
  const int vec = (f % 4 == 0 && aligned(vp, 16) && aligned(uo, 16)) ? 4
                  : (f % 2 == 0 && aligned(vp, 8) && aligned(uo, 8)) ? 2
                                                                     : 1;
  cudaError_t err;
  if (vec == 4)
    err = dispatch<4>(hf / 4 > hs ? hf / 4 : hs, ip, sp, ps, pu, vp, so, uo,
                      n_dst, n_src, n_edges, h, f, st);
  else if (vec == 2)
    err = dispatch<2>(hf / 2 > hs ? hf / 2 : hs, ip, sp, ps, pu, vp, so, uo,
                      n_dst, n_src, n_edges, h, f, st);
  else
    err = dispatch<1>(hf > hs ? hf : hs, ip, sp, ps, pu, vp, so, uo, n_dst,
                      n_src, n_edges, h, f, st);
  return (int)err;
}
