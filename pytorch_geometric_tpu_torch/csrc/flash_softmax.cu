// Online-softmax segment attention for Hopper (sm_90a), float32: the
// forward (`pgt_flash_fwd`, kernel a) and the two passes of its backward
// (`pgt_flash_bwd_dst`, kernel b; `pgt_flash_bwd_src`, kernel c), for three
// logit forms:
//
//   gat:   logit = leaky(a_src[s, h] + a_dst[d, h]),        value v[s, h]
//   gatv2: logit = att[h] . leaky(x_l[s, h] + x_r[d, h]),   value x_l[s, h]
//   dot:   logit = p[rel, h] * <q[d, h], k[s, h]>,          value v[s, h]
//
//   out[d, h] = sum_e exp(logit_e - m[d, h]) value_e / l[d, h]
//
// with the row max m, the normaliser l (m = -inf, l = 0 and out = 0 for a
// row without edges) and the backward's alpha = exp(logit - m) / max(l,
// 1e-16), dalpha = <g[d], value>, dlogit = alpha (dalpha - <g[d], out[d]>).
//
// It replaces no Pallas body. The JAX package runs these as XLA lax.scans
// over fixed edge chunks (pytorch_geometric_tpu/ops/edge_attention.py:
// `_attention_flash` :321-456, `_gat_flash` :801-926, `_gatv2_flash`
// :1070-1184, and the source-sorted backward of `_attention_flash_dual`
// :459-551), whose every chunk gathers [C, H*F] rows, writes them, and
// scatters them back into [N, .] carries that it rescales whole.
//
// Bound on the card: bytes. The least traffic is the node tables read once,
// the edge list and the outputs; a pass gathers one value row (and a logit
// operand) per edge, which come from device memory where the rows are
// random (a products-scale table is many times the 50 MB L2). Design:
//
//   * a row of more than `split` edges is cut into pieces of `split` edges
//     (the hub rows of a power-law graph would otherwise hold up a whole
//     launch); the plan maps each piece to its row (`piece_row`). A piece
//     writes its partials to a scratch slot and takes a ticket; the warp
//     that takes the last ticket merges the row's partials in piece order
//     and writes the row. So the result does not depend on which warp
//     finishes last, and two launches give the same bits (the ticket
//     counters are the only atomics, and they add nothing to a sum);
//   * sums stay in registers: nothing per edge is written to device memory
//     and no sum takes an atomic. The global reductions (GATv2's d att [H*F],
//     the dot form's d p [R, H]) are summed per warp in registers or in a
//     shared-memory row, then per block in a fixed order into per-block
//     partials, which the wrapper sums in block order;
//   * all three kernels, designed for the gather: one warp owns one piece
//     and a group of `team_heads` heads, all H where the row allows. An
//     edge's index (and the dot form's relation) is loaded once for all
//     heads, and its row is read as 16-byte vectors (`vec` = 4, where the
//     columns and every row stride and pointer allow; floats otherwise; the
//     flash route pads each head to a multiple of 4 columns,
//     ops/edge_attention.py). Each head is padded to
//     `qv` slots of `vec` columns; the warp splits into 32 / `g_lanes`
//     sub-teams of `g_lanes` lanes, lane j holding the slots j, j +
//     g_lanes, ... (a head wider than the lanes takes a warp of its own,
//     each lane PER slots of it, so a lane's per-edge scalars are one per
//     head it holds), and the sub-teams take alternate batches of `unroll`
//     edges, their states merged by a fixed butterfly at the end. A head's
//     sum over its lanes is a butterfly over min(qv, g_lanes) lanes, all
//     the batch's edges (and both sums of the backward's GATv2 and dot
//     forms) in the same rounds. The edge loop is software-pipelined: the
//     next batch's indices are fetched before this batch's rows are used,
//     and with `depth` 2 the next batch's rows too;
//   * kernel (a) keeps one online softmax per head a lane holds: per batch
//     the logits' max, one rescale of (l, acc) where it grew, then one expf
//     per edge; the sub-teams' (m, l, acc) merge by log-sum-exp rescales.
//     Kernel (b) writes one 16-byte record (m, l, gdot, a_dst) per row and
//     head, which kernel (c) reads per edge in one load. The batch and
//     depth of each pass come from an A/B on the card (PERF.md): small
//     batches win in (b) and (c), since the register cap of two blocks an
//     SM (128) spills larger ones.
//
// Plain C interface, bound from Python with ctypes (`FlashArgs` is
// ops/flash_softmax.py::_Args field for field); every launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launch arguments, ops/flash_softmax.py::_Args field for field (outside
// the anonymous namespace: the C entry points take it, and must stay
// visible).
struct FlashArgs {
  const long long* rowptr;      // [n_rows + 1]
  const long long* piece_ptr;   // [n_rows + 1]
  const int* piece_row;         // [max_pieces] the row of each piece
  const long long* split_base;  // [n_rows]
  int* tickets;                 // [n_slots * h], zeroed
  const int* nbr;               // [E] the other endpoint of each edge
  const int* rel;               // [E] relation ids (dot form) or null
  const float* src_tab;         // a_src [N_src, h] / x_l / k
  const float* dst_tab;         // a_dst [N_dst, h] / x_r / q
  const float* val;             // v / x_l
  const float* extra;           // att [h * c] / p [n_rel, h] / null
  float* m;                     // [N_dst, h]
  float* l;                     // [N_dst, h]
  float* out;                   // [N_dst, h * c]
  const float* g;               // [N_dst, h * c]
  float* rec;                   // [N_dst, h, 4]: m, l, gdot, a_dst (b -> c)
  float* d_row;                 // b: d dst_tab; c: d src_tab
  float* d_val;                 // c: d val (gat, dot)
  float* d_glob;                // b: [blocks, h * c] or [blocks, n_rel * h]
  float* part_s;                // [n_slots, h]
  float* part_s2;               // [n_slots, h]
  float* part_v;                // [n_slots, h * c]
  float* part_v2;               // [n_slots, h * c]
  long long n_rows, max_pieces, n_slots;
  long long ld_src, ld_dst, ld_val;
  int form, h, c, g_lanes, split, n_rel;
  // columns a slot, heads a warp, slots a head, slots a lane, edges a
  // batch, batches in flight
  int vec, team_heads, qv, nv, unroll, depth;
  float slope;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum Form { kGat = 0, kGatV2 = 1, kDot = 2 };


__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

__device__ __forceinline__ unsigned team_mask(int g) {
  if (g == 32) return 0xffffffffu;
  const int lane = threadIdx.x & 31;
  return ((1u << g) - 1u) << (lane & ~(g - 1));
}

// -- the kernels: one warp per (piece, head group) ---------------------------
// W consecutive floats: one 16-byte load or store where W = 4.
template <int W>
__device__ __forceinline__ void ldg_vec(float (&d)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else {
    d[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void ldcg_vec(float (&d)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else {
    d[0] = __ldcg(p);
  }
}

template <int W>
__device__ __forceinline__ void st_vec(float* p, const float (&s)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  else
    *p = s[0];
}

// One warp's item: (piece, head group), its row and edge range.
struct Piece {
  bool active;
  long long row, k, np, e0, e1;
  int hg;
};

__device__ __forceinline__ int head_groups(const FlashArgs& a) {
  return (a.h + a.team_heads - 1) / a.team_heads;
}

__device__ __forceinline__ Piece warp_piece(const FlashArgs& a) {
  Piece it;
  const int ng = head_groups(a);
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long total = __ldg(a.piece_ptr + a.n_rows);
  it.active = item < total * ng;
  it.row = it.k = it.np = it.e0 = it.e1 = 0;
  it.hg = 0;
  if (it.active) {
    const long long p = item / ng;
    it.hg = (int)(item - p * ng);
    it.row = __ldg(a.piece_row + p);
    const long long p0 = __ldg(a.piece_ptr + it.row);
    it.k = p - p0;
    it.np = __ldg(a.piece_ptr + it.row + 1) - p0;
    const long long r0 = __ldg(a.rowptr + it.row);
    const long long r1 = __ldg(a.rowptr + it.row + 1);
    it.e0 = r0 + it.k * a.split;
    it.e1 = min(it.e0 + (long long)a.split, r1);
  }
  return it;
}

// A lane's slots: slot k * g_lanes + sub of the warp's head group, k = j *
// PER + q, NH heads a lane of PER slots each. A head holds qv slots of W
// columns: with qv <= g_lanes (PER = 1) each head is an aligned group of qv
// lanes, and with qv = 32 PER (one head a warp) each lane holds PER slots
// of it.
template <int NH, int PER>
struct Slots {
  int head[NH];         // the lane's heads, -1 where it holds none
  bool first[NH];       // the head's first slot: writes the head's scalars
  int col[NH * PER];    // each slot's first column in the row of h * c
  bool ok[NH * PER];    // the slot holds columns
};

template <int W, int NH, int PER>
__device__ __forceinline__ Slots<NH, PER> lane_slots(const FlashArgs& a,
                                                     int hg, int sub) {
  Slots<NH, PER> y;
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int k = j * PER + q, v = k * a.g_lanes + sub;
      const int hl = v / a.qv, w = v - hl * a.qv;
      const int head = hg * a.team_heads + hl;
      const bool real = hl < a.team_heads && head < a.h;
      y.ok[k] = real && w * W < a.c;
      y.col[k] = y.ok[k] ? head * a.c + w * W : 0;
      if (q == 0) {
        y.head[j] = real ? head : -1;
        y.first[j] = real && w == 0;
      }
    }
  return y;
}

// Each head's sum over its lanes, the same bits in every lane of the head:
// a butterfly over min(qv, g_lanes) lanes, the N rows of t in the same
// rounds (a lane's own slots of a head are summed by the caller).
template <int N, int NH>
__device__ __forceinline__ void head_sums(float (&t)[N][NH],
                                          const FlashArgs& a, unsigned mask) {
  const int span = min(a.qv, a.g_lanes);
#pragma unroll 1
  for (int off = span >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < NH; ++j)
        t[n][j] += __shfl_xor_sync(mask, t[n][j], off);
  }
}

// The warp's sub-teams' sums merged by a fixed butterfly: every lane ends
// with the total, the same bits in all.
__device__ __forceinline__ float merge_teams(float v, int lanes) {
  for (int off = lanes; off < 32; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A piece of a split row, for a whole warp: publish the partials (written
// by the caller), take a ticket; true in every lane of the warp that took
// the last one.
__device__ __forceinline__ bool last_piece_warp(const FlashArgs& a,
                                                const Piece& it) {
  __threadfence();
  __syncwarp();
  int last = 0;
  if ((threadIdx.x & 31) == 0) {
    const long long t =
        __ldg(a.split_base + it.row) * head_groups(a) + it.hg;
    last = atomicAdd(a.tickets + t, 1) == (int)(it.np - 1);
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last) __threadfence();
  return last != 0;
}

// A batch's edge ids: the neighbours (-1 past the piece) and relations.
template <int U>
struct Edges {
  int s[U];
  int r[U];
};

template <int FORM, int U>
__device__ __forceinline__ Edges<U> load_edges(const FlashArgs& a,
                                               long long e, long long e1) {
  Edges<U> ix;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = e + u < e1;
    ix.s[u] = in ? __ldg(a.nbr + e + u) : -1;
    ix.r[u] = FORM == kDot && in ? __ldg(a.rel + e + u) : 0;
  }
  return ix;
}

// A sub-team's edge loop over its batches [e, e + U), e = first, first +
// step, ... below e1: the next batch's ids are fetched before this batch's
// rows are used and, with P = 2, the next batch's rows too. `fetch(b, ix)`
// issues a batch's row loads, `use(b, ix)` consumes them; batches are used
// in order, so P does not change a sum.
template <int U, int P, int FORM, class B, class Fetch, class Use>
__device__ __forceinline__ void walk(const FlashArgs& a, long long e,
                                     long long e1, long long step,
                                     Fetch fetch, Use use) {
  if (e >= e1) return;
  if constexpr (P == 1) {
    Edges<U> ix = load_edges<FORM, U>(a, e, e1);
    B b;
    for (; e < e1; e += step) {
      fetch(b, ix);
      const Edges<U> nx = load_edges<FORM, U>(a, e + step, e1);
      use(b, ix);
      ix = nx;
    }
  } else {
    Edges<U> ia = load_edges<FORM, U>(a, e, e1);
    Edges<U> ib = load_edges<FORM, U>(a, e + step, e1);
    B ba, bb;
    fetch(ba, ia);
    for (; e < e1; e += 2 * step) {
      fetch(bb, ib);
      const Edges<U> na = load_edges<FORM, U>(a, e + 2 * step, e1);
      use(ba, ia);
      ia = na;
      if (e + step >= e1) break;
      fetch(ba, ia);
      const Edges<U> nb = load_edges<FORM, U>(a, e + 3 * step, e1);
      use(bb, ib);
      ib = nb;
    }
  }
}

// A batch of gathered source rows (kernels a and b): per edge, the logit
// operand of each head the lane holds (GAT's a_src[s, head], the dot
// form's p[rel, head]), the value slots and the dot form's key slots; 0
// past the piece and on slots that hold no columns.
template <int W, int NH, int PER, int U>
struct SrcRows {
  float op[U][NH];            // gat: a_src[s, head]; dot: p[rel, head]
  float v[U][NH * PER][W];    // the value rows
  float k[U][NH * PER][W];    // dot: the key rows
};

template <int FORM, int W, int NH, int PER, int U>
__device__ __forceinline__ void fetch_src_rows(const FlashArgs& a,
                                               const Slots<NH, PER>& y,
                                               SrcRows<W, NH, PER, U>& b,
                                               const Edges<U>& ix) {
  constexpr int NV = NH * PER;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long s = ix.s[u];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      b.op[u][j] = 0.f;
      if (s < 0 || y.head[j] < 0) continue;
      if (FORM == kGat)
        b.op[u][j] = __ldg(a.src_tab + s * a.ld_src + y.head[j]);
      if (FORM == kDot)
        b.op[u][j] = __ldg(a.extra + (long long)ix.r[u] * a.h + y.head[j]);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int i = 0; i < W; ++i) b.v[u][k][i] = b.k[u][k][i] = 0.f;
      if (s < 0 || !y.ok[k]) continue;
      ldg_vec<W>(b.v[u][k], a.val + s * a.ld_val + y.col[k]);
      if (FORM == kDot)
        ldg_vec<W>(b.k[u][k], a.src_tab + s * a.ld_src + y.col[k]);
    }
  }
}

// -- kernel (a): the forward, destination-major ---------------------------------
// Per destination row and head: m, l and out. A lane keeps one (m, l) per
// head it holds and its slots of acc; per batch it takes the logits (their
// sums over the head's lanes in one butterfly), their max, one rescale of
// (l, acc) where the max grew, then one expf per edge. The sub-teams'
// states are merged by a fixed butterfly of log-sum-exp rescales, then a
// split row's pieces in piece order.
template <int FORM, int W, int NH, int PER, int U, int P>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(FlashArgs a) {
  constexpr int NV = NH * PER;
  const int G = a.g_lanes, H = a.h;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1), st = lane / G, S = 32 / G;
  const unsigned mask = team_mask(G);
  const Piece it = warp_piece(a);
  if (!it.active) return;
  const long long hc = (long long)H * a.c;
  const Slots<NH, PER> y = lane_slots<W, NH, PER>(a, it.hg, sub);

  // the row's operands
  float ad[NH], rowv[NV][W], at[NV][W];
#pragma unroll
  for (int j = 0; j < NH; ++j)
    ad[j] = FORM == kGat && y.head[j] >= 0
                ? __ldg(a.dst_tab + it.row * a.ld_dst + y.head[j])
                : 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i) rowv[k][i] = at[k][i] = 0.f;
    if (!y.ok[k]) continue;
    if (FORM != kGat)
      ldg_vec<W>(rowv[k], a.dst_tab + it.row * a.ld_dst + y.col[k]);
    if (FORM == kGatV2) ldg_vec<W>(at[k], a.extra + y.col[k]);
  }

  float m[NH], l[NH], acc[NV][W];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) acc[k][i] = 0.f;

  using B = SrcRows<W, NH, PER, U>;
  auto fetch = [&](B& b, const Edges<U>& ix) {
    fetch_src_rows<FORM, W, NH, PER, U>(a, y, b, ix);
  };
  auto use = [&](const B& b, const Edges<U>& ix) {
    float lg[U][NH];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NH; ++j)
        lg[u][j] = FORM == kGat ? leaky(b.op[u][j] + ad[j], a.slope) : 0.f;
    if (FORM != kGat) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int i = 0; i < W; ++i)
            lg[u][k / PER] += FORM == kGatV2
                                  ? at[k][i] * leaky(b.v[u][k][i] + rowv[k][i],
                                                     a.slope)
                                  : rowv[k][i] * b.k[u][k][i];
      head_sums<U, NH>(lg, a, mask);
      if (FORM == kDot) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < NH; ++j) lg[u][j] *= b.op[u][j];
      }
    }
    // the batch's max, and one rescale where it grew (expf(-inf) = 0 while
    // m = -inf); ix.s[u] is the same in every lane of the sub-team
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float bm = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ix.s[u] >= 0) bm = fmaxf(bm, lg[u][j]);
      if (bm > m[j]) {
        const float sc = expf(m[j] - bm);
        l[j] *= sc;
#pragma unroll
        for (int q = 0; q < PER; ++q)
#pragma unroll
          for (int i = 0; i < W; ++i) acc[j * PER + q][i] *= sc;
        m[j] = bm;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ix.s[u] < 0) continue;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float z = lg[u][j] == -INFINITY ? 0.f : expf(lg[u][j] - m[j]);
        l[j] += z;
#pragma unroll
        for (int q = 0; q < PER; ++q)
#pragma unroll
          for (int i = 0; i < W; ++i)
            acc[j * PER + q][i] += z * b.v[u][j * PER + q][i];
      }
    }
  };
  walk<U, P, FORM, B>(a, it.e0 + (long long)st * U, it.e1, (long long)S * U,
                      fetch, use);

  // the sub-teams' states, merged by a fixed butterfly of log-sum-exp
  // rescales (a state without edges has m = -inf and weighs 0)
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float mm = fmaxf(m[j], mo);
      const float w = m[j] == -INFINITY ? 0.f : expf(m[j] - mm);
      const float wo = mo == -INFINITY ? 0.f : expf(mo - mm);
      l[j] = l[j] * w + lo * wo;
#pragma unroll
      for (int q = 0; q < PER; ++q)
#pragma unroll
        for (int i = 0; i < W; ++i) {
          float& x = acc[j * PER + q][i];
          x = x * w + __shfl_xor_sync(0xffffffffu, x, off) * wo;
        }
      m[j] = mm;
    }
  }

  // a split row's pieces, merged in piece order by the warp that finishes
  // last
  bool write = true;
  if (it.np > 1) {
    const long long base = __ldg(a.split_base + it.row);
    if (st == 0) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
        if (y.first[j]) {
          a.part_s[(base + it.k) * H + y.head[j]] = m[j];
          a.part_s2[(base + it.k) * H + y.head[j]] = l[j];
        }
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (y.ok[k])
          st_vec<W>(a.part_v + (base + it.k) * hc + y.col[k], acc[k]);
    }
    write = last_piece_warp(a, it);
    if (write) {
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        m[j] = -INFINITY;
        l[j] = 0.f;
        if (y.head[j] < 0) continue;
        for (long long q = 0; q < it.np; ++q)
          m[j] = fmaxf(m[j], __ldcg(a.part_s + (base + q) * H + y.head[j]));
      }
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < W; ++i) acc[k][i] = 0.f;
      for (long long q = 0; q < it.np; ++q) {
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          if (y.head[j] < 0) continue;
          const float mq = __ldcg(a.part_s + (base + q) * H + y.head[j]);
          const float w = mq == -INFINITY ? 0.f : expf(mq - m[j]);
          l[j] += __ldcg(a.part_s2 + (base + q) * H + y.head[j]) * w;
#pragma unroll
          for (int qq = 0; qq < PER; ++qq) {
            const int k = j * PER + qq;
            if (!y.ok[k]) continue;
            float x[W];
            ldcg_vec<W>(x, a.part_v + (base + q) * hc + y.col[k]);
#pragma unroll
            for (int i = 0; i < W; ++i) acc[k][i] += x[i] * w;
          }
        }
      }
    }
  }
  if (!write || st != 0) return;
#pragma unroll
  for (int j = 0; j < NH; ++j)
    if (y.first[j]) {
      a.m[it.row * H + y.head[j]] = m[j];
      a.l[it.row * H + y.head[j]] = l[j];
    }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!y.ok[k]) continue;
    const float inv = 1.f / fmaxf(l[k / PER], 1e-16f);
    float o[W];
#pragma unroll
    for (int i = 0; i < W; ++i) o[i] = acc[k][i] * inv;
    st_vec<W>(a.out + it.row * hc + y.col[k], o);
  }
}

// -- kernel (b): the backward's destination pass -------------------------------
// Per destination row: the record (m, l, gdot = <g, out>, a_dst) and d a_dst
// (gat), d x_r (gatv2) or d q (dot); GATv2's d att and the dot form's d p
// as per-block partials.
template <int FORM, int W, int NH, int PER, int U, int P>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dst_kernel(FlashArgs a) {
  constexpr int NV = NH * PER;
  extern __shared__ float smem[];
  const int G = a.g_lanes, C = a.c, H = a.h, HT = a.team_heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (G - 1), st = lane / G, S = 32 / G;
  const unsigned mask = team_mask(G);
  const Piece it = warp_piece(a);
  const long long hc = (long long)H * C;
  const Slots<NH, PER> y = lane_slots<W, NH, PER>(a, it.hg, sub);
  // the global reduction's shared rows: GATv2 one row of the warp's slots,
  // the dot form one [n_rel, HT] row per sub-team
  const int dot_row = a.n_rel * HT;
  float* sg = smem + (FORM == kGatV2 ? warp * (NV * G * W)
                                     : (warp * S + st) * dot_row);
  if (FORM == kDot) {
    for (int i = lane; i < S * dot_row; i += 32)
      smem[warp * S * dot_row + i] = 0.f;
    __syncwarp();
  }

  float glob[NV][W];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) glob[k][i] = 0.f;

  if (it.active) {
    float gv[NV][W], rowv[NV][W], at[NV][W], gd[1][NH], ad[NH], ms[NH],
        ls[NH];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      gd[0][j] = ad[j] = ms[j] = 0.f;
      ls[j] = 1.f;
      const int head = y.head[j];
      if (head < 0) continue;
      if (FORM == kGat) ad[j] = __ldg(a.dst_tab + it.row * a.ld_dst + head);
      ms[j] = __ldg(a.m + it.row * H + head);
      ls[j] = __ldg(a.l + it.row * H + head);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float o[W];
#pragma unroll
      for (int i = 0; i < W; ++i) gv[k][i] = rowv[k][i] = at[k][i] = o[i] = 0.f;
      if (y.ok[k]) {
        ldg_vec<W>(gv[k], a.g + it.row * hc + y.col[k]);
        ldg_vec<W>(o, a.out + it.row * hc + y.col[k]);
        if (FORM != kGat)
          ldg_vec<W>(rowv[k], a.dst_tab + it.row * a.ld_dst + y.col[k]);
        if (FORM == kGatV2) ldg_vec<W>(at[k], a.extra + y.col[k]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) gd[0][k / PER] += gv[k][i] * o[i];
    }
    head_sums<1, NH>(gd, a, mask);
    if (it.k == 0 && st == 0) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
        if (y.first[j])
          reinterpret_cast<float4*>(a.rec)[it.row * H + y.head[j]] =
              make_float4(ms[j], ls[j], gd[0][j], ad[j]);
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      ms[j] = isfinite(ms[j]) ? ms[j] : 0.f;
      ls[j] = fmaxf(ls[j], 1e-16f);
    }

    float acc_s[NH], acc[NV][W];
#pragma unroll
    for (int j = 0; j < NH; ++j) acc_s[j] = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) acc[k][i] = 0.f;

    using B = SrcRows<W, NH, PER, U>;
    auto fetch = [&](B& b, const Edges<U>& ix) {
      fetch_src_rows<FORM, W, NH, PER, U>(a, y, b, ix);
    };
    auto use = [&](const B& b, const Edges<U>& ix) {
      // rows 0..U-1: <g, v> per edge; GATv2 and dot, rows U..2U-1: the
      // logit's (the base's) partials
      constexpr int N = FORM == kGat ? U : 2 * U;
      float t[N][NH];
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int j = 0; j < NH; ++j) t[n][j] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int i = 0; i < W; ++i) {
            t[u][k / PER] += gv[k][i] * b.v[u][k][i];
            if (FORM == kGatV2)
              t[N - U + u][k / PER] +=
                  at[k][i] * leaky(b.v[u][k][i] + rowv[k][i], a.slope);
            if (FORM == kDot)
              t[N - U + u][k / PER] += rowv[k][i] * b.k[u][k][i];
          }
      head_sums<N, NH>(t, a, mask);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ix.s[u] < 0) continue;  // the same in every lane of the team
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          float logit, base = 0.f;
          if (FORM == kGat) {
            base = b.op[u][j] + ad[j];
            logit = leaky(base, a.slope);
          } else if (FORM == kGatV2) {
            logit = t[N - U + u][j];
          } else {
            base = t[N - U + u][j];
            logit = base * b.op[u][j];
          }
          const float alpha = expf(logit - ms[j]) / ls[j];
          const float dlogit = alpha * (t[u][j] - gd[0][j]);
          if (FORM == kGat) {
            acc_s[j] += base >= 0.f ? dlogit : a.slope * dlogit;
          } else if (FORM == kGatV2) {
#pragma unroll
            for (int q = 0; q < PER; ++q)
#pragma unroll
              for (int i = 0; i < W; ++i) {
                const int k = j * PER + q;
                const float bb = b.v[u][k][i] + rowv[k][i];
                const float dj = dlogit * at[k][i];
                acc[k][i] += bb >= 0.f ? dj : a.slope * dj;
                glob[k][i] += leaky(bb, a.slope) * dlogit;
              }
          } else {
            if (y.first[j])
              sg[ix.r[u] * HT + (y.head[j] - it.hg * HT)] += dlogit * base;
            const float db = dlogit * b.op[u][j];
#pragma unroll
            for (int q = 0; q < PER; ++q)
#pragma unroll
              for (int i = 0; i < W; ++i)
                acc[j * PER + q][i] += db * b.k[u][j * PER + q][i];
          }
        }
      }
    };
    walk<U, P, FORM, B>(a, it.e0 + (long long)st * U, it.e1,
                        (long long)S * U, fetch, use);

    // the sub-teams' sums, then a split row's pieces in piece order
#pragma unroll
    for (int j = 0; j < NH; ++j) acc_s[j] = merge_teams(acc_s[j], G);
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        acc[k][i] = merge_teams(acc[k][i], G);
        if (FORM == kGatV2) glob[k][i] = merge_teams(glob[k][i], G);
      }
    bool write = true;
    if (it.np > 1) {
      const long long base = __ldg(a.split_base + it.row);
      if (st == 0) {
#pragma unroll
        for (int j = 0; j < NH; ++j)
          if (FORM == kGat && y.first[j])
            a.part_s[(base + it.k) * H + y.head[j]] = acc_s[j];
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (FORM != kGat && y.ok[k])
            st_vec<W>(a.part_v + (base + it.k) * hc + y.col[k], acc[k]);
      }
      write = last_piece_warp(a, it);
      if (write) {
#pragma unroll
        for (int j = 0; j < NH; ++j) acc_s[j] = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int i = 0; i < W; ++i) acc[k][i] = 0.f;
        for (long long q = 0; q < it.np; ++q) {
#pragma unroll
          for (int j = 0; j < NH; ++j)
            if (FORM == kGat && y.head[j] >= 0)
              acc_s[j] += __ldcg(a.part_s + (base + q) * H + y.head[j]);
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            if (FORM == kGat || !y.ok[k]) continue;
            float x[W];
            ldcg_vec<W>(x, a.part_v + (base + q) * hc + y.col[k]);
#pragma unroll
            for (int i = 0; i < W; ++i) acc[k][i] += x[i];
          }
        }
      }
    }
    if (write && st == 0) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
        if (FORM == kGat && y.first[j])
          a.d_row[it.row * H + y.head[j]] = acc_s[j];
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (FORM != kGat && y.ok[k])
          st_vec<W>(a.d_row + it.row * hc + y.col[k], acc[k]);
    }
  }

  if (FORM == kGat) return;
  // the block's partial of the global reduction, warps (and the dot form's
  // sub-teams) summed in order
  if (FORM == kGatV2 && it.active && st == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) sg[(k * G + sub) * W + i] = glob[k][i];
  }
  __syncthreads();
  const int ng = head_groups(a);
  const long long first = (long long)blockIdx.x * kWarps;
  const long long total = __ldg(a.piece_ptr + a.n_rows) * ng;
  const int width = FORM == kGatV2 ? H * C : a.n_rel * H;
  for (int t = threadIdx.x; t < width; t += kThreads) {
    float sum = 0.f;
    const int head = FORM == kGatV2 ? t / C : t % H;
    for (int w = 0; w < kWarps && first + w < total; ++w) {
      const int hl = head - (int)((first + w) % ng) * HT;
      if (hl < 0 || hl >= HT) continue;
      if (FORM == kGatV2) {
        const int cc = t - head * C;
        sum += smem[w * (NV * G * W) + (hl * a.qv + cc / W) * W + cc % W];
      } else {
        for (int q = 0; q < S; ++q)
          sum += smem[(w * S + q) * dot_row + (t / H) * HT + hl];
      }
    }
    a.d_glob[(long long)blockIdx.x * width + t] = sum;
  }
}

// -- kernel (c): the backward's source pass ------------------------------------
// Per source row: d a_src and d v (gat), d x_l (gatv2), d k and d v (dot),
// from each edge's destination record and output-gradient row.
template <int W, int NH, int PER, int U>
struct SrcBatch {
  float4 rc[U][NH];           // the destination's record: m, l, gdot, a_dst
  float op[U][NH];            // dot: p[rel, head]
  float g[U][NH * PER][W];    // the output-gradient rows
  float r[U][NH * PER][W];    // gatv2, dot: the destination rows (x_r, q)
};

template <int FORM, int W, int NH, int PER, int U, int P>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_src_kernel(FlashArgs a) {
  constexpr int NV = NH * PER;
  const int G = a.g_lanes, C = a.c, H = a.h;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1), st = lane / G, S = 32 / G;
  const unsigned mask = team_mask(G);
  const Piece it = warp_piece(a);
  if (!it.active) return;
  const long long hc = (long long)H * C;
  const Slots<NH, PER> y = lane_slots<W, NH, PER>(a, it.hg, sub);

  // the source row's operands
  float vs[NV][W], ks[NV][W], at[NV][W], as[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j)
    as[j] = FORM == kGat && y.head[j] >= 0
                ? __ldg(a.src_tab + it.row * a.ld_src + y.head[j])
                : 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i) vs[k][i] = ks[k][i] = at[k][i] = 0.f;
    if (!y.ok[k]) continue;
    ldg_vec<W>(vs[k], a.val + it.row * a.ld_val + y.col[k]);
    if (FORM == kDot)
      ldg_vec<W>(ks[k], a.src_tab + it.row * a.ld_src + y.col[k]);
    if (FORM == kGatV2) ldg_vec<W>(at[k], a.extra + y.col[k]);
  }

  float acc_s[NH], acc[NV][W], acc2[NV][W];
#pragma unroll
  for (int j = 0; j < NH; ++j) acc_s[j] = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) acc[k][i] = acc2[k][i] = 0.f;

  using B = SrcBatch<W, NH, PER, U>;
  const float4* rec = reinterpret_cast<const float4*>(a.rec);
  auto fetch = [&](B& b, const Edges<U>& ix) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long d = ix.s[u];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        b.rc[u][j] = make_float4(0.f, 1.f, 0.f, 0.f);
        b.op[u][j] = 0.f;
        if (d < 0 || y.head[j] < 0) continue;
        b.rc[u][j] = __ldg(rec + d * H + y.head[j]);
        if (FORM == kDot)
          b.op[u][j] = __ldg(a.extra + (long long)ix.r[u] * H + y.head[j]);
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int i = 0; i < W; ++i) b.g[u][k][i] = b.r[u][k][i] = 0.f;
        if (d < 0 || !y.ok[k]) continue;
        ldg_vec<W>(b.g[u][k], a.g + d * hc + y.col[k]);
        if (FORM != kGat)
          ldg_vec<W>(b.r[u][k], a.dst_tab + d * a.ld_dst + y.col[k]);
      }
    }
  };
  auto use = [&](const B& b, const Edges<U>& ix) {
    constexpr int N = FORM == kGat ? U : 2 * U;
    float t[N][NH];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < NH; ++j) t[n][j] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < W; ++i) {
          t[u][k / PER] += b.g[u][k][i] * vs[k][i];
          if (FORM == kGatV2)
            t[N - U + u][k / PER] +=
                at[k][i] * leaky(vs[k][i] + b.r[u][k][i], a.slope);
          if (FORM == kDot) t[N - U + u][k / PER] += b.r[u][k][i] * ks[k][i];
        }
    head_sums<N, NH>(t, a, mask);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ix.s[u] < 0) continue;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float4 rc = b.rc[u][j];
        float logit, base = 0.f;
        if (FORM == kGat) {
          base = as[j] + rc.w;
          logit = leaky(base, a.slope);
        } else if (FORM == kGatV2) {
          logit = t[N - U + u][j];
        } else {
          base = t[N - U + u][j];
          logit = base * b.op[u][j];
        }
        const float ms = isfinite(rc.x) ? rc.x : 0.f;
        const float alpha = expf(logit - ms) / fmaxf(rc.y, 1e-16f);
        const float dlogit = alpha * (t[u][j] - rc.z);
        if (FORM == kGat) acc_s[j] += base >= 0.f ? dlogit : a.slope * dlogit;
        const float db = FORM == kDot ? dlogit * b.op[u][j] : 0.f;
#pragma unroll
        for (int q = 0; q < PER; ++q)
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const int k = j * PER + q;
            if (FORM == kGat) {
              acc[k][i] += alpha * b.g[u][k][i];
            } else if (FORM == kGatV2) {
              const float dj = dlogit * at[k][i];
              const float dv = vs[k][i] + b.r[u][k][i] >= 0.f ? dj
                                                              : a.slope * dj;
              acc[k][i] += dv + alpha * b.g[u][k][i];
            } else {
              acc[k][i] += db * b.r[u][k][i];
              acc2[k][i] += alpha * b.g[u][k][i];
            }
          }
      }
    }
  };
  walk<U, P, FORM, B>(a, it.e0 + (long long)st * U, it.e1, (long long)S * U,
                      fetch, use);

#pragma unroll
  for (int j = 0; j < NH; ++j) acc_s[j] = merge_teams(acc_s[j], G);
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) {
      acc[k][i] = merge_teams(acc[k][i], G);
      if (FORM == kDot) acc2[k][i] = merge_teams(acc2[k][i], G);
    }
  if (it.np > 1) {
    const long long base = __ldg(a.split_base + it.row);
    if (st == 0) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
        if (FORM == kGat && y.first[j])
          a.part_s[(base + it.k) * H + y.head[j]] = acc_s[j];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!y.ok[k]) continue;
        st_vec<W>(a.part_v + (base + it.k) * hc + y.col[k], acc[k]);
        if (FORM == kDot)
          st_vec<W>(a.part_v2 + (base + it.k) * hc + y.col[k], acc2[k]);
      }
    }
    if (!last_piece_warp(a, it)) return;
#pragma unroll
    for (int j = 0; j < NH; ++j) acc_s[j] = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) acc[k][i] = acc2[k][i] = 0.f;
    for (long long q = 0; q < it.np; ++q) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
        if (FORM == kGat && y.head[j] >= 0)
          acc_s[j] += __ldcg(a.part_s + (base + q) * H + y.head[j]);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!y.ok[k]) continue;
        float x[W], x2[W];
        ldcg_vec<W>(x, a.part_v + (base + q) * hc + y.col[k]);
        if (FORM == kDot)
          ldcg_vec<W>(x2, a.part_v2 + (base + q) * hc + y.col[k]);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          acc[k][i] += x[i];
          if (FORM == kDot) acc2[k][i] += x2[i];
        }
      }
    }
  }
  if (st != 0) return;
#pragma unroll
  for (int j = 0; j < NH; ++j)
    if (FORM == kGat && y.first[j]) a.d_row[it.row * H + y.head[j]] = acc_s[j];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!y.ok[k]) continue;
    if (FORM == kGat) {
      st_vec<W>(a.d_val + it.row * hc + y.col[k], acc[k]);
    } else {
      st_vec<W>(a.d_row + it.row * hc + y.col[k], acc[k]);
      if (FORM == kDot) st_vec<W>(a.d_val + it.row * hc + y.col[k], acc2[k]);
    }
  }
}

enum Pass { kFwd = 0, kBwdDst = 1, kBwdSrc = 2 };

template <int PASS, int FORM, int W, int NH, int PER, int U, int P>
cudaError_t launch_pass(const FlashArgs& a, cudaStream_t st) {
  constexpr int NV = NH * PER;
  const int ng = (a.h + a.team_heads - 1) / a.team_heads;
  const long long blocks = (a.max_pieces * ng + kWarps - 1) / kWarps;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if constexpr (PASS == kFwd) {
    flash_fwd_kernel<FORM, W, NH, PER, U, P>
        <<<(unsigned)blocks, kThreads, 0, st>>>(a);
  } else if constexpr (PASS == kBwdSrc) {
    flash_bwd_src_kernel<FORM, W, NH, PER, U, P>
        <<<(unsigned)blocks, kThreads, 0, st>>>(a);
  } else {
    size_t smem = 0;
    if (FORM == kGatV2) smem = sizeof(float) * kWarps * NV * a.g_lanes * W;
    if (FORM == kDot)
      smem = sizeof(float) * kThreads / a.g_lanes * a.n_rel * a.team_heads;
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dst_kernel<FORM, W, NH, PER, U, P>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    flash_bwd_dst_kernel<FORM, W, NH, PER, U, P>
        <<<(unsigned)blocks, kThreads, smem, st>>>(a);
  }
  return cudaGetLastError();
}

constexpr int edges_a_batch(int floats, int per_edge) {
  return floats / per_edge < 1 ? 1
         : floats / per_edge > 16 ? 16 : floats / per_edge;
}

// Each pass's batch (gathered row floats a lane, `unroll` edges of nv *
// vec) and batches in flight (`depth`), as ops/flash_softmax.py::_batch
// chooses them from PERF.md's A/Bs: kernel (a) kFwdFloats floats, kernels
// (b) and (c) kBwdFloats; kernels (a) and (b) two batches in flight where a
// lane holds 8 or more floats of a row. The library holds these instances
// only.
constexpr int kFwdFloats = 16, kBwdFloats = 8;

template <int FORM, int W, int NH, int PER>
cudaError_t launch_batch(int pass, const FlashArgs& a, cudaStream_t st) {
  constexpr int F = NH * PER * W;
  constexpr int UA = edges_a_batch(kFwdFloats, F);
  constexpr int UB = edges_a_batch(kBwdFloats, F);
  constexpr int P = F >= 8 ? 2 : 1;
  if (pass == kFwd && a.unroll == UA && a.depth == P)
    return launch_pass<kFwd, FORM, W, NH, PER, UA, P>(a, st);
  if (pass == kBwdDst && a.unroll == UB && a.depth == P)
    return launch_pass<kBwdDst, FORM, W, NH, PER, UB, P>(a, st);
  if (pass == kBwdSrc && a.unroll == UB && a.depth == 1)
    return launch_pass<kBwdSrc, FORM, W, NH, PER, UB, 1>(a, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The team shape must tile the row (every head's qv slots held by the
// warp's lanes) and, for 16-byte vectors, every table read or written by
// vectors must be 16-byte aligned with row strides of whole vectors.
bool shape_ok(int pass, const FlashArgs& a) {
  const int g = a.g_lanes, qv = a.qv;
  if (g <= 0 || g > 32 || (g & (g - 1)) != 0 || qv <= 0 ||
      (qv & (qv - 1)) != 0 || (long long)qv * a.vec < a.c ||
      a.team_heads <= 0 || a.team_heads > a.h ||
      (long long)a.nv * g < (long long)a.team_heads * qv ||
      (qv > g && (g != 32 || qv / g != a.nv || a.team_heads != 1)) ||
      a.unroll <= 0 ||
      (a.depth != 1 && a.depth != 2) || !aligned16(a.rec))
    return false;
  if (a.vec == 1) return true;
  if (a.vec != 4 || a.c % 4 != 0) return false;
  const bool rows = a.form != kGat;
  bool ok = aligned16(a.g) && aligned16(a.val) && a.ld_val % 4 == 0 &&
            aligned16(a.d_val) && aligned16(a.part_v) &&
            aligned16(a.part_v2) &&
            (!rows || (aligned16(a.dst_tab) && a.ld_dst % 4 == 0 &&
                       aligned16(a.d_row)));
  if (a.form == kDot) ok = ok && aligned16(a.src_tab) && a.ld_src % 4 == 0;
  if (a.form == kGatV2) ok = ok && aligned16(a.extra);
  if (pass != kBwdSrc) ok = ok && aligned16(a.out);
  return ok;
}

// The lane layout: NH heads of one slot (PER = 1), or one head of PER
// slots (a head wider than the warp's lanes).
template <int FORM>
cudaError_t launch_form(int pass, const FlashArgs& a, cudaStream_t st) {
  if (!shape_ok(pass, a)) return cudaErrorInvalidValue;
  const int per = a.qv > a.g_lanes ? a.qv / a.g_lanes : 1;
  const int nh = a.nv / per;
  if (a.vec == 4 && per == 1) {
    switch (nh) {
      case 1: return launch_batch<FORM, 4, 1, 1>(pass, a, st);
      case 2: return launch_batch<FORM, 4, 2, 1>(pass, a, st);
      case 4: return launch_batch<FORM, 4, 4, 1>(pass, a, st);
    }
  } else if (a.vec == 4 && nh == 1) {
    switch (per) {
      case 2: return launch_batch<FORM, 4, 1, 2>(pass, a, st);
      case 4: return launch_batch<FORM, 4, 1, 4>(pass, a, st);
    }
  } else if (a.vec == 1 && per == 1) {
    switch (nh) {
      case 1: return launch_batch<FORM, 1, 1, 1>(pass, a, st);
      case 2: return launch_batch<FORM, 1, 2, 1>(pass, a, st);
      case 4: return launch_batch<FORM, 1, 4, 1>(pass, a, st);
      case 8: return launch_batch<FORM, 1, 8, 1>(pass, a, st);
      case 16: return launch_batch<FORM, 1, 16, 1>(pass, a, st);
    }
  } else if (a.vec == 1 && nh == 1) {
    switch (per) {
      case 2: return launch_batch<FORM, 1, 1, 2>(pass, a, st);
      case 4: return launch_batch<FORM, 1, 1, 4>(pass, a, st);
      case 8: return launch_batch<FORM, 1, 1, 8>(pass, a, st);
      case 16: return launch_batch<FORM, 1, 1, 16>(pass, a, st);
    }
  }
  return cudaErrorInvalidValue;
}

int run(int pass, const FlashArgs* args, void* stream) {
  const FlashArgs& a = *args;
  if (a.h <= 0 || a.c <= 0 || a.split <= 0 || a.n_rows < 0 ||
      (a.form == kDot && a.n_rel <= 0))
    return (int)cudaErrorInvalidValue;
  if (a.n_rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (a.form) {
    case kGat:
      return (int)launch_form<kGat>(pass, a, st);
    case kGatV2:
      return (int)launch_form<kGatV2>(pass, a, st);
    case kDot:
      return (int)launch_form<kDot>(pass, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel (a): out, m and l of every destination row (args->rowptr and
// args->nbr the destination-major CSR of the valid edges, their sources as
// neighbours). Runs on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int pgt_flash_fwd(const FlashArgs* args, void* stream) {
  return run(kFwd, args, stream);
}

// Kernel (b): the record (m, l, gdot, a_dst) of every destination row and
// head, the destination-side gradient, and the per-block partials of the
// global reduction (GATv2, dot), over the same CSR.
extern "C" int pgt_flash_bwd_dst(const FlashArgs* args, void* stream) {
  return run(kBwdDst, args, stream);
}

// Kernel (c): the source-side gradients over the source-major CSR (the
// destinations as neighbours); reads the records kernel (b) wrote.
extern "C" int pgt_flash_bwd_src(const FlashArgs* args, void* stream) {
  return run(kBwdSrc, args, stream);
}
