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
// Bound on the card: bytes. The least traffic is v, p_s, p_u, src, indptr,
// s and u once each, but the kernel gathers one row of v per slot, and the
// gathers (slots * H*F * sizeof(T), 2.15 GB at a 100k x 256 float32 v with
// 2.1M slots) dwarf the rest. They can only come from L2, so the design is
// an L2-resident, column-sliced gather:
//
//   * the H*F columns are cut into slices of `w` columns (the caller picks w
//     from the card's L2 size, ops/gat_fused.py::mix_slice_cols). One launch
//     covers every slice; the slice is the grid's slowest index
//     (blockIdx.y), and blocks are dispatched in order, so the whole card
//     gathers from one slice of v at a time and that slice, n_src * w *
//     sizeof(T) bytes, stays in L2: device memory serves v about once;
//   * the slot streams (src, p_u) are read again for every slice, with
//     plain loads: streaming loads (ld.global.cs, evict first), meant to
//     keep them from pushing the slice of v out of L2, made every width
//     slower on the card, and an L2::evict_last hint on the gathers of v
//     changed nothing (PERF.md);
//   * a group of `lanes` lanes of one warp owns one destination row within a
//     slice (lanes = the slice's vector columns, at most 32, not a power of
//     two in general: the columns need no reduction across lanes), so
//     several rows share a warp and few lanes idle; a vector of VEC elements
//     may straddle two heads (H*F % VEC == 0 is what the vectors need, not
//     F % VEC == 0), each element then weighted by the p_u of its own head;
//   * the edge loop is unrolled by eight slots (float32; four for bf16):
//     their src, p_u and v loads are issued before any of their sums, so
//     eight row gathers are in flight per lane; the gathers come from L2,
//     whose latency, not its rate, held the four-slot loop back;
//   * the f32 accumulators stay in registers for the whole edge run and each
//     output row is written once, zeros for an empty row; `s` is summed by
//     the blocks of slice 0 only;
//   * no atomics: every sum is taken in CSC order, so the result is
//     deterministic and the same bits for every slice width and vector width;
//   * `s` counts every slot of the row; `u` skips a slot whose source lies
//     outside [0, n_src), as the JAX package masks `v[src]`; the padded slots
//     past indptr[n_dst] are never read, and a row's run is clamped to
//     [0, n_edges), so a malformed indptr reads nothing out of bounds.
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

constexpr int kThreads = 256;

// ONE: every vector lies within one head (F % VEC == 0), so a slot needs one
// weight; otherwise each element loads the weight of its own head.
template <typename T, int VEC, bool ONE>
__global__ void __launch_bounds__(kThreads)
gat_mix_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
               const T* __restrict__ p_s, const T* __restrict__ p_u,
               const T* __restrict__ v, T* __restrict__ s_out,
               T* __restrict__ u_out, long long n_dst, long long n_src,
               long long n_edges, int h, int f, int w, int lanes) {
  constexpr int NW = ONE ? 1 : VEC;  // weights per slot
  // slots whose loads are in flight together: 8 for float32; 4 for bf16,
  // whose wider vectors would cost registers, and occupancy, at 8
  constexpr int kUnroll = sizeof(T) == 4 ? 8 : 4;
  const int rows_per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31;
  const int group = lane / lanes;
  if (group >= rows_per_warp) return;  // the lanes a group width leaves over
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long row = warp * rows_per_warp + group;
  if (row >= n_dst) return;
  const int glane = lane - group * lanes;
  const long long beg =
      min(max((long long)__ldg(indptr + row), 0LL), n_edges);
  const long long end = min((long long)__ldg(indptr + row + 1), n_edges);

  if (s_out != nullptr && blockIdx.y == 0) {
    for (int c = glane; c < h; c += lanes) {
      float acc = 0.f;
      for (long long k = beg; k < end; ++k) acc += to_float(p_s[k * h + c]);
      store_vec<T, 1>(s_out + row * h + c, &acc);
    }
  }
  if (u_out == nullptr) return;

  const long long hf = (long long)h * f;
  const int nv = w / VEC;  // vector columns in a slice
  for (int c = glane; c < nv; c += lanes) {
    const long long col = (long long)blockIdx.y * w + (long long)c * VEC;
    int head[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) head[i] = (int)((col + i) / f);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

    long long k = beg;
    for (; k + kUnroll <= end; k += kUnroll) {
      int s[kUnroll];
      bool ok[kUnroll];
      float wt[kUnroll][NW];
      float x[kUnroll][VEC];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        s[j] = __ldg(src + k + j);
        ok[j] = s[j] >= 0 && s[j] < n_src;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
#pragma unroll
        for (int i = 0; i < NW; ++i)
          wt[j][i] = to_float(p_u[(k + j) * h + head[i]]);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (ok[j]) {
          load_vec<T, VEC>(v + (long long)s[j] * hf + col, x[j]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (!ok[j]) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = Msg<T>::add(acc[i], wt[j][ONE ? 0 : i], x[j][i], true);
      }
    }
    for (; k < end; ++k) {
      const int s = __ldg(src + k);
      if (s < 0 || s >= n_src) continue;
      float wt[NW];
      float x[VEC];
#pragma unroll
      for (int i = 0; i < NW; ++i) wt[i] = to_float(p_u[k * h + head[i]]);
      load_vec<T, VEC>(v + (long long)s * hf + col, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] = Msg<T>::add(acc[i], wt[ONE ? 0 : i], x[i], true);
    }
    store_vec<T, VEC>(u_out + row * hf + col, acc);
  }
}

template <typename T, int VEC, bool ONE>
cudaError_t launch(const int* indptr, const int* src, const T* p_s,
                   const T* p_u, const T* v, T* s_out, T* u_out,
                   long long n_dst, long long n_src, long long n_edges, int h,
                   int f, int w, int lanes, int slices, cudaStream_t stream) {
  const long long rows_per_block = (kThreads / 32) * (32 / lanes);
  const long long blocks = (n_dst + rows_per_block - 1) / rows_per_block;
  const dim3 grid((unsigned)blocks, (unsigned)slices);
  gat_mix_kernel<T, VEC, ONE><<<grid, kThreads, 0, stream>>>(
      indptr, src, p_s, p_u, v, s_out, u_out, n_dst, n_src, n_edges, h, f, w,
      lanes);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest vector (at most 16 bytes) that H*F and the slice width divide
// and v and u are aligned to; lanes per row from the slice's vector columns
// (or the H heads of s, if wider), at most a warp.
template <typename T>
cudaError_t run(const void* indptr, const void* src, const void* p_s,
                const void* p_u, const void* v, void* s_out, void* u_out,
                long long n_dst, long long n_src, long long n_edges, int h,
                int f, int w, void* stream) {
  if (n_dst <= 0 || h <= 0 || (s_out == nullptr && u_out == nullptr))
    return cudaSuccess;
  if (u_out != nullptr && f <= 0) u_out = nullptr;
  const long long hf = u_out ? (long long)h * f : 0;
  if (u_out == nullptr) w = 0;
  // w tiles H*F exactly, and the slices fit the grid's y extent
  if (u_out != nullptr && (w <= 0 || hf % w != 0 || hf / w > 65535))
    return cudaErrorInvalidValue;
  const int slices = u_out ? (int)(hf / w) : 1;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const T* ps = static_cast<const T*>(p_s);
  const T* pu = static_cast<const T*>(p_u);
  const T* vp = static_cast<const T*>(v);
  T* so = static_cast<T*>(s_out);
  T* uo = static_cast<T*>(u_out);
  const int hs = so ? h : 0;
  constexpr int kMax = 16 / (int)sizeof(T);  // 4 floats or 8 bf16
  auto fits = [&](int vec) {
    const int bytes = vec * (int)sizeof(T);
    return hf % vec == 0 && w % vec == 0 && aligned(vp, bytes) &&
           aligned(uo, bytes);
  };
  auto go = [&](auto vec_tag) {
    constexpr int VEC = decltype(vec_tag)::value;
    const int width = w / VEC > hs ? w / VEC : hs;
    const int lanes = width < 1 ? 1 : (width > 32 ? 32 : width);
    if (uo == nullptr || f % VEC == 0)
      return launch<T, VEC, true>(ip, sp, ps, pu, vp, so, uo, n_dst, n_src,
                                  n_edges, h, f, w, lanes, slices, st);
    return launch<T, VEC, false>(ip, sp, ps, pu, vp, so, uo, n_dst, n_src,
                                 n_edges, h, f, w, lanes, slices, st);
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
// or both set; v, p_u and u_out likewise (no u). slice_cols: the columns of
// one slice of v, a divisor of h * f (ignored without u). Runs on `stream`
// and does not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a slice width that does not tile h * f.
extern "C" int pgt_gat_mix_f32(const void* indptr, const void* src,
                               const void* p_s, const void* p_u,
                               const void* v, void* s_out, void* u_out,
                               long long n_dst, long long n_src,
                               long long n_edges, int h, int f,
                               int slice_cols, void* stream) {
  return (int)run<float>(indptr, src, p_s, p_u, v, s_out, u_out, n_dst,
                         n_src, n_edges, h, f, slice_cols, stream);
}

// The same with p_s, p_u, v, s_out and u_out all bfloat16: messages
// bf16(p_u * v), float32 sums, s and u rounded once.
extern "C" int pgt_gat_mix_bf16(const void* indptr, const void* src,
                                const void* p_s, const void* p_u,
                                const void* v, void* s_out, void* u_out,
                                long long n_dst, long long n_src,
                                long long n_edges, int h, int f,
                                int slice_cols, void* stream) {
  return (int)run<__nv_bfloat16>(indptr, src, p_s, p_u, v, s_out, u_out,
                                 n_dst, n_src, n_edges, h, f, slice_cols,
                                 stream);
}
