// Per-edge, per-head dot product for Hopper (sm_90a), float32
// (`pgt_edge_dot_f32`) and bfloat16 (`pgt_edge_dot_bf16`):
//
//   out[e, h] = sum_f a[ia[e], h, f] * b[ib[e], h, f]
//
// and 0 where ia[e] lies outside [0, na), ib[e] outside [0, nb), or the
// optional edge mask is false.
//
// It replaces no Pallas body. The JAX package leaves this product to XLA
// as `(a[src] * b[dst]).sum(-1)`: `sddmm` (pytorch_geometric_tpu/ops/
// sddmm.py:38), the logits, `dalpha` and `base` of the wide-gather
// attention (ops/edge_attention.py:110, :139, :145), the scores of
// TransformerConv (nn/conv/transformer_conv.py:65) and SuperGATConv
// (nn/conv/gps_conv.py:230-233), and `grad_p_u` of the mix's VJP
// (ops/gat_fused.py:103-105). XLA, like PyTorch's plain version, writes
// the two gathered `[E, H, F]` operands to device memory and reads them
// back; here each row is read once into registers and never written.
//
// Bound on the card: bytes. The least traffic is a, b, ia, ib (and the
// mask) read once and `[E, H]` written once; the kernel gathers one row of
// a and one of b per edge (E * H*F * sizeof(T) each: 2.15 GB at 2.1M
// edges and H*F = 256 float32), which come from L2 where the rows repeat
// (the sorted side of a slot order) and from device memory elsewhere.
// Design:
//
//   * the heads are cut into slices of whole heads (the caller picks the
//     width from the card's L2 size, ops/edge_dot.py::dot_slice_heads). One
//     launch covers every slice; the slice is the grid's slowest index
//     (blockIdx.y), and blocks are dispatched in order, so the whole card
//     gathers from one slice of the tables at a time and that slice, na *
//     hs * F * sizeof(T) bytes of a, stays in L2, as in the mix kernel
//     (gat_mix.cu): the index arrays are read once per slice. A slice
//     writes complete heads, so the result is the same bits for every
//     slice width;
//   * each head is read in vectors of VEC elements (16 bytes where the head
//     width F and the pointers allow it, else 8, 4 or 2 bytes, else one
//     element): a vector never straddles two heads, so at F = 10 (a head of
//     40 bytes) the loads are 8 bytes wide;
//   * a team of G lanes (a power of two, G <= 32) owns one (edge, head)
//     item, and each lane loads up to 16 elements of the head from each
//     table at once (four 16-byte float32 vectors, two bf16 ones), all
//     issued before any product: G is the fewest lanes whose chunks cover
//     the head (4 at F = 64 float32, 1 at F = 10, so one lane computes a
//     40-byte head alone with no shuffle). The items are taken in (edge,
//     head) order, so the teams of one warp read neighbouring rows. An A/B
//     of this shape against one 16-byte vector a lane and four items a
//     team took path D's grad_p_u from 1.16 to 0.42 ms (PERF.md);
//   * each head's partial sums are reduced across the team by xor shuffles
//     (log2 G steps), and lane 0 writes the item: no atomics, so the result
//     is the same bits on every run;
//   * row offsets are 64-bit (ia[e] * row stride), and the indices may be
//     int32 or int64 (the slot orders keep their row ids as int64).
//
// The bf16 arm loads bf16, rounds each product to bf16 (as XLA's and
// PyTorch's bf16 multiply does), sums in float32 and rounds the result to
// bf16 once.
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

constexpr int kThreads = 256;
// elements of a head one lane loads from each table at once (16 floats:
// four 16-byte vectors; 16 bf16: two)
constexpr int kLaneElems = 16;

__device__ __forceinline__ long long load_index(const void* p, bool wide,
                                                long long e) {
  return wide ? __ldg(static_cast<const long long*>(p) + e)
              : (long long)__ldg(static_cast<const int*>(p) + e);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
edge_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const void* __restrict__ ia, const void* __restrict__ ib,
                const unsigned char* __restrict__ mask, T* __restrict__ out,
                long long n_edges, long long na, long long nb, long long lda,
                long long ldb, int h, int f, int hs, bool ia64, bool ib64,
                int g) {
  constexpr int V = kLaneElems / VEC;  // vectors a lane loads of each row
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);  // lane within the team
  // the slice's items: (edge, head) over its hs heads, one a team
  const long long item =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / g;
  const long long n_items = n_edges * hs;
  const int vh = f / VEC;  // vectors per head

  bool ok = item < n_items;
  long long row_a = 0, row_b = 0, slot = 0;
  if (ok) {
    const long long e = item / hs;
    const int head = blockIdx.y * hs + (int)(item - e * hs);
    slot = e * h + head;
    const long long i = load_index(ia, ia64, e);
    const long long j = load_index(ib, ib64, e);
    ok = i >= 0 && i < na && j >= 0 && j < nb &&
         (mask == nullptr || __ldg(mask + e) != 0);
    row_a = i * lda + (long long)head * f;
    row_b = j * ldb + (long long)head * f;
  }

  float acc = 0.f;
  // the lane's chunk from column vector c0 on: every load issued before any
  // product
  auto chunk = [&](int c0) {
    float x[V][VEC], y[V][VEC];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = c0 + sub + v * g;
      if (ok && c < vh) {
        load_vec<T, VEC>(a + row_a + (long long)c * VEC, x[v]);
        load_vec<T, VEC>(b + row_b + (long long)c * VEC, y[v]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[v][i] = y[v][i] = 0.f;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc = Msg<T>::add(acc, x[v][i], y[v][i], true);
  };
  // one chunk covers a head of up to 32 * kLaneElems elements, every width
  // the paths use; wider heads take more, the same count in every lane
  chunk(0);
  for (int c0 = g * V; c0 < vh; c0 += g * V) chunk(c0);
  // every lane of the warp reaches the shuffles; a team's lanes are an
  // aligned group of g, which xor offsets below g never leave
  for (int off = g >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && item < n_items) {
    float r = ok ? acc : 0.f;
    store_vec<T, 1>(out + slot, &r);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
cudaError_t launch(const void* a, const void* b, const void* ia,
                   const void* ib, const void* mask, void* out,
                   long long n_edges, long long na, long long nb,
                   long long lda, long long ldb, int h, int f, int hs,
                   int ia64, int ib64, cudaStream_t stream) {
  // lanes a team: the fewest (a power of two, at most 32) whose
  // kLaneElems-element chunks cover a head
  const int vh = f / VEC, per_lane = kLaneElems / VEC;
  int g = 1;
  while (g * per_lane < vh && g < 32) g *= 2;
  const long long n_items = n_edges * hs;  // per slice
  const long long teams_per_block = kThreads / g;
  const long long blocks =
      (n_items + teams_per_block - 1) / teams_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(h / hs));
  edge_dot_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), ia, ib,
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), n_edges,
      na, nb, lda, ldb, h, f, hs, ia64 != 0, ib64 != 0, g);
  return cudaGetLastError();
}

// The widest vector (at most 16 bytes) that divides the head width F and
// both row strides, and to which a and b are aligned.
template <typename T>
cudaError_t run(const void* a, const void* b, const void* ia, const void* ib,
                const void* mask, void* out, long long n_edges, long long na,
                long long nb, long long lda, long long ldb, int h, int f,
                int hs, int ia64, int ib64, void* stream) {
  if (n_edges <= 0 || h <= 0) return cudaSuccess;
  if (f <= 0 || lda < (long long)h * f || ldb < (long long)h * f ||
      hs <= 0 || h % hs != 0 || h / hs > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  constexpr int kMax = 16 / (int)sizeof(T);  // 4 floats or 8 bf16
  auto fits = [&](int vec) {
    const int bytes = vec * (int)sizeof(T);
    return f % vec == 0 && lda % vec == 0 && ldb % vec == 0 &&
           aligned(a, bytes) && aligned(b, bytes);
  };
#define PGT_EDGE_DOT_GO(V)                                                  \
  return launch<T, V>(a, b, ia, ib, mask, out, n_edges, na, nb, lda, ldb, h, \
                      f, hs, ia64, ib64, st)
  if (fits(kMax)) PGT_EDGE_DOT_GO(kMax);
  if (fits(kMax / 2)) PGT_EDGE_DOT_GO(kMax / 2);
  if (kMax >= 4 && fits(kMax / 4)) PGT_EDGE_DOT_GO(kMax >= 4 ? kMax / 4 : 1);
  if (kMax >= 8 && fits(kMax / 8)) PGT_EDGE_DOT_GO(kMax >= 8 ? kMax / 8 : 1);
  PGT_EDGE_DOT_GO(1);
#undef PGT_EDGE_DOT_GO
}

}  // namespace

// a [na, h * f] and b [nb, h * f] float32, row-major with row strides lda
// and ldb elements (at least h * f); slice_heads, the heads of one slice
// (a divisor of h); ia and ib [n_edges]
// int32 (ia64 / ib64 = 0) or int64 (1); mask [n_edges] bytes (0 drops the
// edge) or null; out [n_edges, h] float32. Runs on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for f <= 0, a row stride below h * f, a slice that
// does not tile the heads or a grid past the card's limit.
extern "C" int pgt_edge_dot_f32(const void* a, const void* b, const void* ia,
                                const void* ib, const void* mask, void* out,
                                long long n_edges, long long na,
                                long long nb, long long lda, long long ldb,
                                int h, int f, int slice_heads, int ia64,
                                int ib64, void* stream) {
  return (int)run<float>(a, b, ia, ib, mask, out, n_edges, na, nb, lda, ldb,
                         h, f, slice_heads, ia64, ib64, stream);
}

// The same with a, b and out bfloat16: products bf16(a * b), a float32
// sum, the result rounded once.
extern "C" int pgt_edge_dot_bf16(const void* a, const void* b,
                                 const void* ia, const void* ib,
                                 const void* mask, void* out,
                                 long long n_edges, long long na,
                                 long long nb, long long lda, long long ldb,
                                 int h, int f, int slice_heads, int ia64,
                                 int ib64, void* stream) {
  return (int)run<__nv_bfloat16>(a, b, ia, ib, mask, out, n_edges, na, nb,
                                 lda, ldb, h, f, slice_heads, ia64, ib64,
                                 stream);
}
