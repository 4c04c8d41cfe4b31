// Segment-sum SpMM over a destination-sorted CSC, for Hopper (sm_90a):
// float32 (`pgt_segment_spmm_f32`) and bfloat16 (`pgt_segment_spmm_bf16`).
//
//   out[d, :] = sum_{k = indptr[d]}^{indptr[d+1]-1} w[k] * x[src[k], :]
//
// Replaces the TPU kernel `_chunk_kernel` (pytorch_geometric_tpu/ops/
// pallas_spmm.py:74, launched at :132 and :212) together with its XLA
// segment-sum epilogue. The TPU kernel turns the scatter into a one-hot
// matmul so that it runs on the MXU; a Hopper SM gains nothing from that, so
// this kernel reads the CSC directly:
//
//   * a group of LANES lanes of one warp owns one destination row (LANES = 32
//     for F >= 128 floats, fewer for narrow F, so one warp serves several
//     rows), and each lane strides the feature columns, VEC floats at a time;
//   * the f32 accumulators stay in registers for the whole edge run and the
//     output row is written once, zeros for an empty row;
//   * no atomics: every row's sum is taken in CSC order, so the result is
//     deterministic, as the XLA and Pallas sums are;
//   * edges with a source outside [0, n_src) contribute nothing, the padded
//     edges past indptr[n_dst] are never read, and a row's edge run is
//     clamped to [0, n_edges), so a malformed indptr reads nothing out of
//     bounds.
//
// Bound on the card: bytes. Each edge reads one x row (F * 4 bytes) at a
// random source, so the kernel streams E * F * 4 bytes of gathers that mostly
// hit L2 when x fits in it (30k x 128 floats = 15 MB of a 50 MB L2); the
// least traffic from device memory is x, src, w, indptr and out once each.
// The edge loop is unrolled by four so that four independent row loads are in
// flight per lane.
//
// The bf16 arm is the TPU kernel's bf16-message path (ops/pallas_spmm.py:
// 199-229: bf16 messages streamed, widened on chip, summed in float32, the
// result in the messages' dtype). Each message is formed as XLA forms
// `x[src] * w` in bf16: the product of two bf16 values (exact in float32)
// rounded once to bf16, or x itself when w is absent; the sum runs in float32
// registers and is rounded to bf16 once, on the store. Rows move 8 bf16 (16
// bytes) or 4 (8 bytes) a lane, so the gathered bytes are half the float32
// arm's.
//
// Plain C interface, bound from Python with ctypes; every launch returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

using pgt::load_vec;
using pgt::Msg;
using pgt::store_vec;

// The edge weight as float32, 1 when there is none.
__device__ __forceinline__ float weight_of(const float* __restrict__ w,
                                           long long k) {
  return w ? __ldg(w + k) : 1.f;
}

__device__ __forceinline__ float weight_of(const __nv_bfloat16* __restrict__ w,
                                           long long k) {
  return w ? __bfloat162float(w[k]) : 1.f;
}

template <typename T, int VEC>
__device__ __forceinline__ void load_or_zero(const T* __restrict__ x, int s,
                                             long long n_src, long long f,
                                             long long col, bool active,
                                             float* v) {
  if (active && s >= 0 && s < n_src) {
    load_vec<T, VEC>(x + (long long)s * f + col, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = 0.f;
}

template <typename T, int VEC>
__device__ __forceinline__ void add_vec(float* acc, float wk, const float* t,
                                        bool weighted) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = Msg<T>::add(acc[i], wk, t[i], weighted);
}

constexpr int kThreads = 256;

template <typename T, int VEC, int LANES>
__global__ void __launch_bounds__(kThreads)
segment_spmm_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ src, const T* __restrict__ w,
                    const T* __restrict__ x, T* __restrict__ out,
                    long long n_dst, long long n_src, long long f,
                    long long n_edges) {
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
  const long long fv = f / VEC;  // vector columns in a row
  const bool weighted = w != nullptr;

  for (long long c0 = 0; c0 < fv; c0 += LANES) {
    const long long c = c0 + glane;
    const bool active = c < fv;
    const long long col = c * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

    long long k = beg;
    for (; k + 4 <= end; k += 4) {
      const int s0 = __ldg(src + k);
      const int s1 = __ldg(src + k + 1);
      const int s2 = __ldg(src + k + 2);
      const int s3 = __ldg(src + k + 3);
      const float w0 = weight_of(w, k);
      const float w1 = weight_of(w, k + 1);
      const float w2 = weight_of(w, k + 2);
      const float w3 = weight_of(w, k + 3);
      float t0[VEC], t1[VEC], t2[VEC], t3[VEC];
      load_or_zero<T, VEC>(x, s0, n_src, f, col, active, t0);
      load_or_zero<T, VEC>(x, s1, n_src, f, col, active, t1);
      load_or_zero<T, VEC>(x, s2, n_src, f, col, active, t2);
      load_or_zero<T, VEC>(x, s3, n_src, f, col, active, t3);
      add_vec<T, VEC>(acc, w0, t0, weighted);
      add_vec<T, VEC>(acc, w1, t1, weighted);
      add_vec<T, VEC>(acc, w2, t2, weighted);
      add_vec<T, VEC>(acc, w3, t3, weighted);
    }
    for (; k < end; ++k) {
      const int s = __ldg(src + k);
      const float wk = weight_of(w, k);
      float t[VEC];
      load_or_zero<T, VEC>(x, s, n_src, f, col, active, t);
      add_vec<T, VEC>(acc, wk, t, weighted);
    }
    if (active) store_vec<T, VEC>(out + row * f + col, acc);
  }
}

template <typename T, int VEC, int LANES>
cudaError_t launch(const int* indptr, const int* src, const T* w, const T* x,
                   T* out, long long n_dst, long long n_src, long long f,
                   long long n_edges, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = (kThreads / 32) * (32 / LANES);
  const long long blocks = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  segment_spmm_kernel<T, VEC, LANES><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indptr, src, w, x, out, n_dst, n_src, f, n_edges);
  return cudaGetLastError();
}

// Lanes per row: the smallest power of two that covers the row's vector
// columns, at most a whole warp.
template <typename T, int VEC>
cudaError_t dispatch(const int* indptr, const int* src, const T* w,
                     const T* x, T* out, long long n_dst, long long n_src,
                     long long f, long long n_edges, cudaStream_t stream) {
  const long long fv = f / VEC;
#define PGT_LAUNCH(L) \
  return launch<T, VEC, L>(indptr, src, w, x, out, n_dst, n_src, f, n_edges, stream)
  if (fv <= 1) PGT_LAUNCH(1);
  if (fv <= 2) PGT_LAUNCH(2);
  if (fv <= 4) PGT_LAUNCH(4);
  if (fv <= 8) PGT_LAUNCH(8);
  if (fv <= 16) PGT_LAUNCH(16);
  PGT_LAUNCH(32);
#undef PGT_LAUNCH
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// indptr [n_dst + 1] int32, src [n_edges] int32, w [n_edges] float32 or null
// (all ones), x [n_src, f] float32 row-major, out [n_dst, f] float32. Runs on `stream`
// and does not synchronise. Returns cudaGetLastError() after the launch.
extern "C" int pgt_segment_spmm_f32(const void* indptr, const void* src,
                                    const void* w, const void* x, void* out,
                                    long long n_dst, long long n_src,
                                    long long f, long long n_edges,
                                    void* stream) {
  if (n_dst <= 0 || f <= 0) return (int)cudaSuccess;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const float* wp = static_cast<const float*>(w);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  // 16-byte vector loads need a row stride and both bases that are multiples
  // of four floats; anything else takes the scalar path.
  const bool vec4 = f % 4 == 0 && aligned(x, 16) && aligned(out, 16);
  const cudaError_t err =
      vec4 ? dispatch<float, 4>(ip, sp, wp, xp, op, n_dst, n_src, f, n_edges, s)
           : dispatch<float, 1>(ip, sp, wp, xp, op, n_dst, n_src, f, n_edges, s);
  return (int)err;
}

// The same with w [n_edges] bfloat16 or null, x [n_src, f] and out [n_dst, f]
// bfloat16: messages bf16(w * x), float32 sums, out rounded once.
extern "C" int pgt_segment_spmm_bf16(const void* indptr, const void* src,
                                     const void* w, const void* x, void* out,
                                     long long n_dst, long long n_src,
                                     long long f, long long n_edges,
                                     void* stream) {
  if (n_dst <= 0 || f <= 0) return (int)cudaSuccess;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  // 16-byte loads of 8 values, else 8-byte loads of 4, else scalars
  cudaError_t err;
  if (f % 8 == 0 && aligned(x, 16) && aligned(out, 16))
    err = dispatch<__nv_bfloat16, 8>(ip, sp, wp, xp, op, n_dst, n_src, f,
                                     n_edges, s);
  else if (f % 4 == 0 && aligned(x, 8) && aligned(out, 8))
    err = dispatch<__nv_bfloat16, 4>(ip, sp, wp, xp, op, n_dst, n_src, f,
                                     n_edges, s);
  else
    err = dispatch<__nv_bfloat16, 1>(ip, sp, wp, xp, op, n_dst, n_src, f,
                                     n_edges, s);
  return (int)err;
}
