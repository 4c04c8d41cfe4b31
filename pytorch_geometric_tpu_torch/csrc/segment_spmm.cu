// Segment-sum SpMM over a destination-sorted CSC, for Hopper (sm_90a):
// float32 (`pgt_segment_spmm_f32`) and bfloat16 (`pgt_segment_spmm_bf16`).
//
//   out[d, :] = base[d, :] + sum_{k = indptr[d]}^{indptr[d+1]-1} w[k] * x[src[k], :]
//
// with `base` optional (zeros when absent). Replaces the TPU kernel
// `_chunk_kernel` (pytorch_geometric_tpu/ops/pallas_spmm.py:74, launched at
// :132 and :212) together with its XLA segment-sum epilogue, and the XLA add
// of the block-sparse arm's residual (pytorch_geometric_tpu/ops/spmm.py:
// 435-441: `out + segment_sum(...)`, which XLA fuses into one pass). The TPU
// kernel turns the scatter into a one-hot matmul so that it runs on the MXU;
// a Hopper SM gains nothing from that, so this kernel reads the CSC directly.
//
// What bounds it on an H100. The least traffic is x, base and out once each
// plus the indices and weights (E * 8 bytes) from HBM at 3.35 TB/s. The
// kernel itself gathers one x row per edge, E * F * itemsize bytes:
//   * serving (30k nodes, 1.03M edges, x 15 MB at F = 128) and path B (10k
//     nodes) hold x in the 50 MB L2, so the gathers are L2 traffic, about
//     9-45x the HBM bytes. Wide rows (512 bytes at F = 128) run at the L2's
//     rate, about 7 TB/s; narrow ones (40-64 bytes) and small grids are
//     bound by the latency of dependent loads;
//   * path A's residual (250k nodes, 494k edges, ~2 per row, x 64 MB at
//     F = 64) gathers from HBM at random and reads and writes [N, F] base
//     and out: HBM bytes and the latency of a short row bound it.
// Latency-bound kernels want many warps, so registers are bounded (40 in
// the direct mode, 64 staged; __launch_bounds__) and row loads are kept raw
// until they are summed: a load's branch holds nothing that waits on its
// data, so a lane's row loads are in flight together.
//
// The design, per launch plan (vec, lanes, groups, rows_per_warp, staged),
// chosen on the host (ops/segment_spmm.py::segment_plan) and refused here if
// it does not tile a warp:
//   * a lane group of `lanes` lanes covers a row's columns, `vec` values a
//     lane (16-, 8- or 4-byte loads, or scalars; F = 10 in float32 takes
//     8-byte loads on 5 of 8 lanes); `groups` lane groups share one row (a
//     team of lanes * groups lanes), and a warp serves rows_per_warp rows;
//   * staged mode, for narrow rows (lanes <= 8): edge batches staged by the
//     warp. Each lane loads its own (src, w) pairs, one coalesced load per
//     team and slot, and `__shfl_sync` hands every pair to the lanes that
//     need it; the next batch's pairs are loaded before the current batch's
//     rows are summed, and each lane keeps up to 4 row loads in flight. A
//     warp runs as many edge slots as its longest row needs, counted in a
//     value all its lanes share, so no lane diverges around a shuffle;
//   * direct mode, for wide rows (lanes >= 16, one group a row): each lane
//     group loads its own pairs (one address a group, served by L1) four
//     at a time, then their four rows; with one group the stride is a
//     constant and the compiler loads the next four indices while the rows
//     are in flight. Staging measured slower there (PERF.md), so the plan
//     keeps this shape;
//   * split edge runs (staged mode): lane group g takes the row's edges
//     beg + g, beg + g + groups, ... in order into its own float32 partial;
//     a fixed `__shfl_xor_sync` tree (xor lanes, 2 * lanes, ...) then adds
//     the partials. Both modes take the same sums in the same order, every
//     output is one sum in one fixed order, with no atomics, so two launches
//     (and the two modes) are bitwise equal;
//   * `base` is read once by the lanes that store and added to the finished
//     sum, as `out + segment_sum(...)` adds it: one rounding, the same as
//     the two passes it replaces;
//   * edges with a source outside [0, n_src) contribute nothing, whatever
//     their weight, the padded edges past indptr[n_dst] are never read, and
//     a row's edge run is clamped to [0, n_edges), so a malformed indptr
//     reads nothing out of bounds.
//
// The bf16 arm is the TPU kernel's bf16-message path (ops/pallas_spmm.py:
// 199-229: bf16 messages streamed, widened on chip, summed in float32, the
// result in the messages' dtype). Each message is formed as XLA forms
// `x[src] * w` in bf16: the product of two bf16 values (exact in float32)
// rounded once to bf16, or x itself when w is absent; the sum (and base,
// widened) runs in float32 registers and is rounded to bf16 once, on the
// store.
//
// Plain C interface, bound from Python with ctypes; every entry point returns
// cudaErrorInvalidValue without launching for a plan that does not tile, and
// cudaGetLastError() after a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

using pgt::load_vec;
using pgt::Msg;
using pgt::store_vec;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// row loads a lane keeps in flight in the staged mode: more would cost the
// registers of warps, which these latency-bound loops need more
constexpr int kInFlight = 4;

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// The edge weight as float32, 1 when there is none.
__device__ __forceinline__ float weight_of(const float* __restrict__ w,
                                           long long k) {
  return w ? __ldg(w + k) : 1.f;
}

__device__ __forceinline__ float weight_of(const __nv_bfloat16* __restrict__ w,
                                           long long k) {
  return w ? __bfloat162float(w[k]) : 1.f;
}

// VEC values of T as one load moves them, kept raw until they are summed: a
// load's branch then holds nothing that waits on its data, so a lane's row
// loads are all in flight at once.
template <typename T, int VEC>
struct Raw;
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<float, 2> { using type = float2; };
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };

// Row s of x at column col, or zeros for an inactive lane or s < 0.
template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_row(
    const T* __restrict__ x, int s, long long f, long long col, bool active) {
  using R = typename Raw<T, VEC>::type;
  R r{};
  if (active && s >= 0)
    r = __ldg(reinterpret_cast<const R*>(x + (long long)s * f + col));
  return r;
}

__device__ __forceinline__ void widen(float4 r, float* v) {
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void widen(float2 r, float* v) {
  v[0] = r.x;
  v[1] = r.y;
}
__device__ __forceinline__ void widen(float r, float* v) { v[0] = r; }
__device__ __forceinline__ void widen(uint4 r, float* v) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  pgt::unpack_bf16<4>(w, v);
}
__device__ __forceinline__ void widen(uint2 r, float* v) {
  const uint32_t w[2] = {r.x, r.y};
  pgt::unpack_bf16<2>(w, v);
}
__device__ __forceinline__ void widen(unsigned short r, float* v) {
  v[0] = __bfloat162float(__ushort_as_bfloat16(r));
}

// acc += w * row (Msg<T>: one FMA in float32, bf16(w * x) for bf16)
template <typename T, int VEC, typename R>
__device__ __forceinline__ void add_row(float* acc, float wk, R r,
                                        bool weighted) {
  float t[VEC];
  widen(r, t);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = Msg<T>::add(acc[i], wk, t[i], weighted);
}

// A team's (src, w) pairs at positions off + i * team + tl of its row, slot
// i: src -1 and weight 0 past the row's end or for a source outside
// [0, n_src). Both loads are issued before either is used.
template <typename T, int STAGE>
__device__ __forceinline__ void stage_edges(const int* __restrict__ src,
                                            const T* __restrict__ w,
                                            long long beg, int n_row, int off,
                                            int team, int tl, long long n_src,
                                            int* s, float* wv) {
#pragma unroll
  for (int i = 0; i < STAGE; ++i) {
    const int pos = off + i * team + tl;
    int v = -1;
    float ww = 0.f;
    if (pos < n_row) {
      v = __ldg(src + beg + pos);
      ww = weight_of(w, beg + pos);
    }
    const bool ok = v >= 0 && v < n_src;
    s[i] = ok ? v : -1;
    wv[i] = ok ? ww : 0.f;
  }
}

template <typename T>
struct Args {
  const int* indptr;
  const int* src;
  const T* w;
  const T* x;
  const T* base;
  T* out;
  long long n_dst, n_src, f, n_edges;
};

// Where a lane stands in its warp under a plan: LANES lanes a lane group,
// 1 << log_groups groups a row (a team), the rest rows of the warp.
template <int LANES>
struct Team {
  static constexpr int kLogLanes = ilog2(LANES);
  int log_groups, log_team, team, tl, grp, col_lane;
  __device__ __forceinline__ explicit Team(int lg) : log_groups(lg) {
    log_team = kLogLanes + lg;
    team = 1 << log_team;
    const int lane = threadIdx.x & 31;
    tl = lane & (team - 1);
    grp = tl >> kLogLanes;
    col_lane = tl & (LANES - 1);
  }
};

// Staged mode: lane group grp's sum of its row's edges beg + grp + j * groups
// (j = 0, 1, ...) into acc, from (src, w) pairs staged by the team and
// handed out by shuffles; every lane of the warp runs the loop max_n (the
// warp's longest row) sets.
template <typename T, int VEC, int LANES, bool WEIGHTED>
__device__ __forceinline__ void staged_sum(const Args<T>& a, const Team<LANES>& m,
                                           long long beg, int n_row, int max_n,
                                           long long col, bool active,
                                           float* acc) {
  // pairs a lane stages per batch, and edges a lane group takes per batch
  constexpr int kStage = LANES >= kInFlight ? 1 : kInFlight / LANES;
  constexpr int kRun = kStage * LANES;
  constexpr int kLogLanes = Team<LANES>::kLogLanes;
  const int lane = threadIdx.x & 31;
  // the lane that holds group grp's first pair of a slot
  const int from0 = lane - m.tl + m.grp;
  const int batch = kRun << m.log_groups;  // a team's edges per batch
  int cs[kStage];
  float cw[kStage];
  stage_edges<T, kStage>(a.src, a.w, beg, n_row, 0, m.team, m.tl, a.n_src,
                         cs, cw);
  for (int off = 0; off < max_n; off += batch) {
    int ns[kStage];
    float nw[kStage];
    const bool more = off + batch < max_n;
    if (more)
      stage_edges<T, kStage>(a.src, a.w, beg, n_row, off + batch, m.team,
                             m.tl, a.n_src, ns, nw);
    // the group runs (q) of this batch that some row of the warp still
    // has: a chunk takes only its first `n`, a count the whole warp shares,
    // so no lane diverges (guards, not breaks, keep every index a constant
    // and the arrays in registers)
    const int runs = (max_n - off + (1 << m.log_groups) - 1) >> m.log_groups;
#pragma unroll
    for (int q0 = 0; q0 < kRun; q0 += kInFlight) {
      const int n = runs - q0;
      if (n <= 0) continue;
      typename Raw<T, VEC>::type t[kInFlight];
      float wq[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (u < n) {
          // group grp's q-th edge of the batch sits at position q * groups
          // + grp: slot q / LANES of lane (q % LANES) * groups + grp of the
          // team
          const int q = q0 + u;
          const int from = from0 + ((q & (LANES - 1)) << m.log_groups);
          const int s = __shfl_sync(kFull, cs[q >> kLogLanes], from);
          wq[u] = WEIGHTED ? __shfl_sync(kFull, cw[q >> kLogLanes], from) : 1.f;
          t[u] = load_row<T, VEC>(a.x, s, a.f, col, active);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (u < n) add_row<T, VEC>(acc, wq[u], t[u], WEIGHTED);
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        cs[i] = ns[i];
        cw[i] = nw[i];
      }
    }
  }
}

// Direct mode: the same sum in the same order, each lane
// group loading its own pairs (one address a group, served by L1) four
// edges at a time, then their four rows; a row's lanes stop at its own end.
// With one group the stride is the constant 1, which lets the compiler load
// the next four indices while the current rows are in flight.
template <typename T, int VEC, bool WEIGHTED, bool UNIT>
__device__ __forceinline__ void direct_run(const Args<T>& a, long long k,
                                           long long end, int stride,
                                           long long col, bool active,
                                           float* acc) {
  const int step = UNIT ? 1 : stride;
  for (; k + 3 * step < end; k += 4 * step) {
    int s[4];
    float wq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[u] = __ldg(a.src + k + u * step);
      wq[u] = WEIGHTED ? weight_of(a.w, k + u * step) : 1.f;
    }
    typename Raw<T, VEC>::type t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // a source outside [0, n_src) adds nothing, whatever its weight
      const bool ok = s[u] >= 0 && s[u] < a.n_src;
      t[u] = load_row<T, VEC>(a.x, ok ? s[u] : -1, a.f, col, active);
      wq[u] = ok ? wq[u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) add_row<T, VEC>(acc, wq[u], t[u], WEIGHTED);
  }
  for (; k < end; k += step) {
    const int s = __ldg(a.src + k);
    const bool ok = s >= 0 && s < a.n_src;
    const float wk = ok ? (WEIGHTED ? weight_of(a.w, k) : 1.f) : 0.f;
    add_row<T, VEC>(acc, wk, load_row<T, VEC>(a.x, ok ? s : -1, a.f, col,
                                              active),
                    WEIGHTED);
  }
}

template <typename T, int VEC, int LANES, bool WEIGHTED>
__device__ __forceinline__ void direct_sum(const Args<T>& a, const Team<LANES>& m,
                                           long long beg, int n_row,
                                           long long col, bool active,
                                           float* acc) {
  if (m.log_groups == 0)
    direct_run<T, VEC, WEIGHTED, true>(a, beg, beg + n_row, 1, col, active,
                                       acc);
  else
    direct_run<T, VEC, WEIGHTED, false>(a, beg + m.grp, beg + n_row,
                                        1 << m.log_groups, col, active, acc);
}

// The kernels are bound by the latency of dependent loads, so they keep the
// blocks an SM holds high: 6 of 256 threads for the direct mode (40
// registers), 4 for the staged one (64).
template <bool STAGED>
__host__ __device__ constexpr int min_blocks() {
  return STAGED ? 4 : 6;
}

template <typename T, int VEC, int LANES, bool WEIGHTED, bool STAGED>
__global__ void __launch_bounds__(kThreads, min_blocks<STAGED>())
segment_spmm_kernel(const Args<T> a, int log_groups) {
  const Team<LANES> m(log_groups);
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long row0 = warp << (5 - m.log_team);
  if (row0 >= a.n_dst) return;  // the whole warp lies past the end
  const long long row = row0 + (lane >> m.log_team);
  const bool live = row < a.n_dst;
  long long beg = 0;
  int n_row = 0;
  if (live) {
    beg = min(max((long long)__ldg(a.indptr + row), 0LL), a.n_edges);
    const long long end = min((long long)__ldg(a.indptr + row + 1), a.n_edges);
    n_row = (int)max(end - beg, 0LL);
  }
  const int max_n =
      STAGED ? (int)__reduce_max_sync(kFull, (unsigned)n_row) : 0;
  const long long fv = a.f / VEC;  // vector columns in a row

  for (long long c0 = 0; c0 < fv; c0 += LANES) {
    const bool active = live && c0 + m.col_lane < fv;
    const long long col = (c0 + m.col_lane) * VEC;
    const bool stores = active && m.grp == 0;
    float acc[VEC], bv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = bv[i] = 0.f;
    if (a.base && stores) load_vec<T, VEC>(a.base + row * a.f + col, bv);
    if (STAGED)
      staged_sum<T, VEC, LANES, WEIGHTED>(a, m, beg, n_row, max_n, col,
                                          active, acc);
    else
      direct_sum<T, VEC, LANES, WEIGHTED>(a, m, beg, n_row, col, active, acc);
    // the groups' partials, in one fixed tree
    for (int k = LANES; k < m.team; k <<= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] += __shfl_xor_sync(kFull, acc[i], k);
    }
    if (stores) {
      if (a.base) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += bv[i];
      }
      store_vec<T, VEC>(a.out + row * a.f + col, acc);
    }
  }
}

template <typename T, int VEC, int LANES, bool WEIGHTED, bool STAGED>
cudaError_t launch(const Args<T>& a, int log_groups, cudaStream_t stream) {
  const long long rows_per_block =
      (long long)(kThreads / 32) << (5 - ilog2(LANES) - log_groups);
  const long long blocks = (a.n_dst + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  segment_spmm_kernel<T, VEC, LANES, WEIGHTED, STAGED>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(a, log_groups);
  return cudaGetLastError();
}

template <typename T, int VEC, int LANES>
cudaError_t launch_mode(const Args<T>& a, int log_groups, bool staged,
                        cudaStream_t stream) {
  const bool weighted = a.w != nullptr;
  if (staged)
    return weighted ? launch<T, VEC, LANES, true, true>(a, log_groups, stream)
                    : launch<T, VEC, LANES, false, true>(a, log_groups, stream);
  return weighted ? launch<T, VEC, LANES, true, false>(a, log_groups, stream)
                  : launch<T, VEC, LANES, false, false>(a, log_groups, stream);
}

template <typename T, int VEC>
cudaError_t dispatch(const Args<T>& a, int lanes, int log_groups, bool staged,
                     cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch_mode<T, VEC, 1>(a, log_groups, staged, stream);
    case 2: return launch_mode<T, VEC, 2>(a, log_groups, staged, stream);
    case 4: return launch_mode<T, VEC, 4>(a, log_groups, staged, stream);
    case 8: return launch_mode<T, VEC, 8>(a, log_groups, staged, stream);
    case 16: return launch_mode<T, VEC, 16>(a, log_groups, staged, stream);
    case 32: return launch_mode<T, VEC, 32>(a, log_groups, staged, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

bool pow2(int v) { return v >= 1 && (v & (v - 1)) == 0; }

// The plan tiles a warp: lanes * groups * rows_per_warp = 32, all powers of
// two; vec divides F, and x, out and base are aligned to vec elements;
// staged is 0 or 1.
template <typename T>
bool plan_tiles(const Args<T>& a, int vec, int lanes, int groups,
                int rows_per_warp, int staged) {
  if (!pow2(vec) || !pow2(lanes) || !pow2(groups) || !pow2(rows_per_warp) ||
      (staged != 0 && staged != 1))
    return false;
  if (lanes > 32 || lanes * groups > 32 || lanes * groups * rows_per_warp != 32)
    return false;
  const int bytes = vec * (int)sizeof(T);
  return a.f % vec == 0 && aligned(a.x, bytes) && aligned(a.out, bytes) &&
         (a.base == nullptr || aligned(a.base, bytes));
}

template <typename T>
Args<T> args_of(const void* indptr, const void* src, const void* w,
                const void* x, const void* base, void* out, long long n_dst,
                long long n_src, long long f, long long n_edges) {
  return Args<T>{static_cast<const int*>(indptr),
                 static_cast<const int*>(src),
                 static_cast<const T*>(w),
                 static_cast<const T*>(x),
                 static_cast<const T*>(base),
                 static_cast<T*>(out),
                 n_dst,
                 n_src,
                 f,
                 n_edges};
}

}  // namespace

// indptr [n_dst + 1] int32, src [n_edges] int32, w [n_edges] float32 or null
// (all ones), x [n_src, f] float32 row-major, base [n_dst, f] float32 or null
// (zeros), out [n_dst, f] float32; the plan (vec in {1, 2, 4}, lanes,
// groups, rows_per_warp) as segment_plan gives it. Runs on `stream` and does
// not synchronise.
extern "C" int pgt_segment_spmm_f32(const void* indptr, const void* src,
                                    const void* w, const void* x,
                                    const void* base, void* out,
                                    long long n_dst, long long n_src,
                                    long long f, long long n_edges, int vec,
                                    int lanes, int groups, int rows_per_warp,
                                    int staged, void* stream) {
  const Args<float> a = args_of<float>(indptr, src, w, x, base, out, n_dst,
                                       n_src, f, n_edges);
  if (!plan_tiles(a, vec, lanes, groups, rows_per_warp, staged) || vec > 4)
    return (int)cudaErrorInvalidValue;
  if (n_dst <= 0 || f <= 0) return (int)cudaSuccess;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int lg = ilog2(groups);
  switch (vec) {
    case 4: return (int)dispatch<float, 4>(a, lanes, lg, staged, s);
    case 2: return (int)dispatch<float, 2>(a, lanes, lg, staged, s);
    case 1: return (int)dispatch<float, 1>(a, lanes, lg, staged, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The same with w [n_edges], x [n_src, f], base [n_dst, f] and out
// [n_dst, f] bfloat16, vec in {1, 4, 8}: messages bf16(w * x), float32
// sums, out rounded once.
extern "C" int pgt_segment_spmm_bf16(const void* indptr, const void* src,
                                     const void* w, const void* x,
                                     const void* base, void* out,
                                     long long n_dst, long long n_src,
                                     long long f, long long n_edges, int vec,
                                     int lanes, int groups, int rows_per_warp,
                                     int staged, void* stream) {
  const Args<__nv_bfloat16> a = args_of<__nv_bfloat16>(
      indptr, src, w, x, base, out, n_dst, n_src, f, n_edges);
  if (!plan_tiles(a, vec, lanes, groups, rows_per_warp, staged) || vec == 2)
    return (int)cudaErrorInvalidValue;
  if (n_dst <= 0 || f <= 0) return (int)cudaSuccess;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int lg = ilog2(groups);
  switch (vec) {
    case 8: return (int)dispatch<__nv_bfloat16, 8>(a, lanes, lg, staged, s);
    case 4: return (int)dispatch<__nv_bfloat16, 4>(a, lanes, lg, staged, s);
    case 1: return (int)dispatch<__nv_bfloat16, 1>(a, lanes, lg, staged, s);
  }
  return (int)cudaErrorInvalidValue;
}
