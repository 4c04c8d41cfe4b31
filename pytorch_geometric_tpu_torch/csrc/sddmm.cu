// Per-edge, per-head dot product for Hopper (sm_90a), float32
// (`pgt_edge_dot_f32`, and `pgt_edge_dot_runs_f32` for a call whose one
// side comes in runs) and bfloat16 (`pgt_edge_dot_bf16`,
// `pgt_edge_dot_runs_bf16`):
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
// and the slice of the tables being read fits there, and from device
// memory elsewhere. Design:
//
//   * a head is read in leaves of VEC elements (16 bytes where the head
//     width F, both row strides and both pointers allow it, else 8, 4 or 2
//     bytes, else one element; the wrapper picks VEC): a leaf never
//     straddles two heads. A head's sum is a fixed tree over its leaves,
//     padded with zero leaves to a power of two P: each leaf's VEC
//     products in order, then neighbouring leaves and subtrees in pairs.
//     A lane holds up to 16 elements (M leaves) of one head, contiguous,
//     and sums its subtree in registers; the head's lanes then pair up by
//     xor shuffles at offsets 1, 2, 4, ..., the next levels of the same
//     tree. (Lane r holding the leaves k * lanes + r instead, each block of
//     neighbouring leaves summed by shuffles first, gives the same tree and
//     ran slower in the A/B of PERF.md.) No atomics: the result is the same
//     bits on every run;
//   * the work is cut into slices, each the grid's slowest index
//     (blockIdx.y), and blocks are dispatched in order, so the whole card
//     gathers from one slice of the tables at a time and that slice stays
//     in L2 (the wrapper, ops/edge_dot.py::dot_plan, sizes it from the L2
//     and the rows of both tables, leaving out a table read at most once a
//     row). A slice is `hs` whole heads, or, where one head of both tables
//     does not fit, a column slice of `sl` leaves of one head (a subtree
//     of the head's tree). A column slice writes its subtree's sum to a
//     float32 partial [slices, E, H], and a second kernel sums the
//     partials by the tree's upper levels and rounds once. So the result
//     is the same bits for every slice width;
//   * a team of G lanes owns one edge and the heads of its slice that fit
//     in 32 lanes: the edge's indices (and mask) are loaded once for them
//     all. Items are taken in (edge, team) order, so the teams of one warp
//     read neighbouring edges. A lane's place comes from shifts (lanes
//     and heads are powers of two), and the kernel is built for four
//     blocks an SM (64 registers a thread): both won the A/B of PERF.md;
//   * a call whose one side comes in runs (a slot order's sorted
//     destinations) takes the runs arm below instead: a team of lanes per
//     (edge, head) reading strided vectors, which the A/B found faster
//     there (its own order of sums, the same bits for each of its slice
//     widths of whole heads); so does a head too wide for the tree arm's
//     64 column slices, which the runs arm reads in as many chunks as it
//     needs;
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

#include "vec.cuh"

namespace {

using pgt::load_vec;
using pgt::Msg;
using pgt::store_vec;

constexpr int kThreads = 256;
// elements of a head one lane holds of each table (16 floats: four 16-byte
// leaves; 16 bf16: two)
constexpr int kLaneElems = 16;

__device__ __forceinline__ long long load_index(const void* p, bool wide,
                                                long long e) {
  return wide ? __ldg(static_cast<const long long*>(p) + e)
              : (long long)__ldg(static_cast<const int*>(p) + e);
}

// -- the tree arm ---------------------------------------------------------------
// The launch's shape: `hs` heads a slice, `sl` leaves a column slice of
// `ncs` per head, 2^`llph` lanes a head, `ht` heads a team of 2^`lg`
// lanes, `tps` teams a slice per edge (powers of two as shifts: no lane
// divides by a runtime value but for tps > 1).
struct DotShape {
  long long n_edges, na, nb, lda, ldb;
  int h, f, nq, hs, sl, ncs, llph, ht, lg, tps;
  bool ia64, ib64;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
edge_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const void* __restrict__ ia, const void* __restrict__ ib,
                const unsigned char* __restrict__ mask, T* __restrict__ out,
                float* __restrict__ part, DotShape d) {
  constexpr int M = kLaneElems / VEC;  // leaves a lane holds
  const int lane = threadIdx.x & 31;
  const int g = 1 << d.lg, lph = 1 << d.llph;
  const int sub = lane & (g - 1);      // lane within the team
  const long long item =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> d.lg;
  const long long n_items = d.n_edges * d.tps;
  const int hb = d.ncs == 1 ? (int)blockIdx.y : (int)blockIdx.y / d.ncs;
  const int cs = (int)blockIdx.y - hb * d.ncs;
  const int ml = min(d.sl, M);         // the lane's leaves
  const int r = sub & (lph - 1);       // the lane's place in its head

  // the lane's edge and head; a team's lanes past the slice's heads hold
  // none
  const long long e = d.tps == 1 ? item : item / d.tps;
  const int hl = (int)(item - e * d.tps) * d.ht + (sub >> d.llph);
  const int head = hb * d.hs + hl;
  const bool mine = item < n_items && hl < d.hs;
  bool ok = mine;
  long long row_a = 0, row_b = 0;
  if (ok) {
    const long long i = load_index(ia, d.ia64, e);
    const long long j = load_index(ib, d.ib64, e);
    ok = i >= 0 && i < d.na && j >= 0 && j < d.nb &&
         (mask == nullptr || __ldg(mask + e) != 0);
    row_a = i * d.lda + (long long)head * d.f;
    row_b = j * d.ldb + (long long)head * d.f;
  }
  const int q0 = cs * d.sl + r * ml;

  // every load issued before any product
  float x[M][VEC], y[M][VEC];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int q = q0 + k;
    if (ok && k < ml && q < d.nq) {
      load_vec<T, VEC>(a + row_a + (long long)q * VEC, x[k]);
      load_vec<T, VEC>(b + row_b + (long long)q * VEC, y[k]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[k][i] = y[k][i] = 0.f;
    }
  }
  // each leaf's products in order
  float s[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    s[k] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      s[k] = Msg<T>::add(s[k], x[k][i], y[k][i], true);
  }
  // the tree's first levels: each block's leaves, paired over the head's
  // lanes (lph is the same in every lane, so every lane of the warp
  // reaches each shuffle) ...

  // ... then the blocks in pairs (blocks past the lane's own are zero
  // subtrees and add exact zeros)
#pragma unroll
  for (int w = 1; w < M; w <<= 1)
#pragma unroll
    for (int k = 0; k + w < M; k += 2 * w) s[k] += s[k + w];
  float v = s[0];
  for (int off = 1; off < lph; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (!mine || r != 0) return;
  if (!ok) v = 0.f;
  if (d.ncs == 1)
    store_vec<T, 1>(out + e * d.h + head, &v);
  else
    part[((long long)cs * d.n_edges + e) * d.h + head] = v;
}

// The column slices' partials of each (edge, head), summed by the upper
// levels of the head's tree (slices past the head's leaves are zero
// subtrees), rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_dot_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                        long long n, int ncs) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  int np = 1;
  while (np < ncs) np <<= 1;
  float v[64];
  for (int k = 0; k < np; ++k) v[k] = k < ncs ? __ldg(part + k * n + t) : 0.f;
  for (int w = 1; w < np; w <<= 1)
    for (int k = 0; k + w < np; k += 2 * w) v[k] += v[k + w];
  store_vec<T, 1>(out + t, v);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T, int VEC>
cudaError_t launch(const void* a, const void* b, const void* ia,
                   const void* ib, const void* mask, void* out, float* part,
                   DotShape d, cudaStream_t stream) {
  const long long n_items = d.n_edges * d.tps;  // per slice
  const long long teams_per_block = kThreads >> d.lg;
  const long long blocks =
      (n_items + teams_per_block - 1) / teams_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(d.h / d.hs * d.ncs));
  edge_dot_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), ia, ib,
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), part, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || d.ncs == 1) return err;
  const long long n = d.n_edges * d.h;
  edge_dot_combine_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(part,
                                                      static_cast<T*>(out), n,
                                                      d.ncs);
  return cudaGetLastError();
}

// Checks the shape the wrapper chose: VEC a power of two up to 16 bytes
// that divides F and both row strides, with both tables aligned to it;
// `slice_heads` whole heads (a divisor of h), or `slice_leaves` leaves of
// one head (a power of two below the head's padded leaves), each lane at
// most kLaneElems elements and a head at most 32 lanes.
template <typename T>
cudaError_t run(const void* a, const void* b, const void* ia, const void* ib,
                const void* mask, void* out, void* part, long long n_edges,
                long long na, long long nb, long long lda, long long ldb,
                int h, int f, int vec, int hs, int sl, int ia64, int ib64,
                void* stream) {
  if (n_edges <= 0 || h <= 0) return cudaSuccess;
  constexpr int kMax = 16 / (int)sizeof(T);  // 4 floats or 8 bf16
  const int bytes = vec * (int)sizeof(T);
  if (f <= 0 || lda < (long long)h * f || ldb < (long long)h * f ||
      vec <= 0 || vec > kMax || (vec & (vec - 1)) != 0 || f % vec != 0 ||
      lda % vec != 0 || ldb % vec != 0 || !aligned(a, bytes) ||
      !aligned(b, bytes) || hs <= 0 || h % hs != 0 || sl <= 0 ||
      (sl & (sl - 1)) != 0)
    return cudaErrorInvalidValue;
  DotShape d;
  d.n_edges = n_edges; d.na = na; d.nb = nb; d.lda = lda; d.ldb = ldb;
  d.h = h; d.f = f; d.nq = f / vec; d.hs = hs; d.sl = sl;
  d.ia64 = ia64 != 0; d.ib64 = ib64 != 0;
  const int lane_leaves = kLaneElems / vec, p = pow2_at_least(d.nq);
  d.ncs = (d.nq + sl - 1) / sl;
  const int lph = sl > lane_leaves ? sl / lane_leaves : 1;
  if (sl > p || lph > 32 || (d.ncs > 1 && hs != 1) || d.ncs > 64 ||
      (long long)h / hs * d.ncs > 65535 || (d.ncs > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  d.llph = 0;
  while ((1 << d.llph) < lph) ++d.llph;
  d.lg = d.llph;
  while ((1 << d.lg) < hs * lph && d.lg < 5) ++d.lg;
  d.ht = (1 << d.lg) / lph;
  d.tps = (hs + d.ht - 1) / d.ht;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  switch (vec) {
    case 1: return launch<T, 1>(a, b, ia, ib, mask, out, pf, d, st);
    case 2: return launch<T, 2>(a, b, ia, ib, mask, out, pf, d, st);
    case 4: return launch<T, 4>(a, b, ia, ib, mask, out, pf, d, st);
  }
  if constexpr (kMax >= 8) {
    if (vec == 8) return launch<T, kMax>(a, b, ia, ib, mask, out, pf, d, st);
  }
  return cudaErrorInvalidValue;
}

// -- the runs arm: a slot order's sorted side --------------------------------
// For calls whose one side comes in runs (a slot order's sorted
// destinations), where this shape won the A/B (PERF.md), and heads too
// wide for the tree arm: a team of g lanes owns one (edge, head),
// lane j loads the head's vectors j, j + g, ... (every load instruction
// reads neighbouring vectors across the lanes), sums its elements in order
// by FMA, then the team's lanes by xor shuffles at offsets g / 2, ..., 1;
// slices of whole heads only, the same bits for every slice width.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
edge_dot_kernel_runs(const T* __restrict__ a, const T* __restrict__ b,
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

template <typename T, int VEC>
cudaError_t launch_runs(const void* a, const void* b, const void* ia,
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
  edge_dot_kernel_runs<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), ia, ib,
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), n_edges,
      na, nb, lda, ldb, h, f, hs, ia64 != 0, ib64 != 0, g);
  return cudaGetLastError();
}

// The widest vector (at most 16 bytes) that divides the head width F and
// both row strides, and to which a and b are aligned.
template <typename T>
cudaError_t run_runs(const void* a, const void* b, const void* ia,
                     const void* ib,
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
  return launch_runs<T, V>(a, b, ia, ib, mask, out, n_edges, na, nb, lda, ldb, h, \
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
// and ldb elements (at least h * f), read `vec` elements at a time; ia and
// ib [n_edges] int32 (ia64 / ib64 = 0) or int64 (1); mask [n_edges] bytes
// (0 drops the edge) or null; out [n_edges, h] float32; slices of
// `slice_heads` whole heads, or of `slice_leaves` leaves of one head with
// `part` a float32 scratch [ceil(f / vec / slice_leaves), n_edges, h] (null
// for whole heads). Runs on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape `run` refuses.
extern "C" int pgt_edge_dot_f32(const void* a, const void* b, const void* ia,
                                const void* ib, const void* mask, void* out,
                                void* part, long long n_edges, long long na,
                                long long nb, long long lda, long long ldb,
                                int h, int f, int vec, int slice_heads,
                                int slice_leaves, int ia64, int ib64,
                                void* stream) {
  return (int)run<float>(a, b, ia, ib, mask, out, part, n_edges, na, nb, lda,
                         ldb, h, f, vec, slice_heads, slice_leaves, ia64,
                         ib64, stream);
}

// The same with a, b and out bfloat16: products bf16(a * b), a float32
// sum, the result rounded once.
extern "C" int pgt_edge_dot_bf16(const void* a, const void* b,
                                 const void* ia, const void* ib,
                                 const void* mask, void* out, void* part,
                                 long long n_edges, long long na,
                                 long long nb, long long lda, long long ldb,
                                 int h, int f, int vec, int slice_heads,
                                 int slice_leaves, int ia64, int ib64,
                                 void* stream) {
  return (int)run<__nv_bfloat16>(a, b, ia, ib, mask, out, part, n_edges, na,
                                 nb, lda, ldb, h, f, vec, slice_heads,
                                 slice_leaves, ia64, ib64, stream);
}

// The runs arm, for a call whose one side comes in runs: the same
// arguments but the vector width and the column slices, which it chooses
// and does not take.
extern "C" int pgt_edge_dot_runs_f32(const void* a, const void* b,
                                     const void* ia, const void* ib,
                                     const void* mask, void* out,
                                     long long n_edges, long long na,
                                     long long nb, long long lda,
                                     long long ldb, int h, int f,
                                     int slice_heads, int ia64, int ib64,
                                     void* stream) {
  return (int)run_runs<float>(a, b, ia, ib, mask, out, n_edges, na, nb, lda,
                              ldb, h, f, slice_heads, ia64, ib64, stream);
}

extern "C" int pgt_edge_dot_runs_bf16(const void* a, const void* b,
                                      const void* ia, const void* ib,
                                      const void* mask, void* out,
                                      long long n_edges, long long na,
                                      long long nb, long long lda,
                                      long long ldb, int h, int f,
                                      int slice_heads, int ia64, int ib64,
                                      void* stream) {
  return (int)run_runs<__nv_bfloat16>(a, b, ia, ib, mask, out, n_edges, na,
                                      nb, lda, ldb, h, f, slice_heads, ia64,
                                      ib64, stream);
}
