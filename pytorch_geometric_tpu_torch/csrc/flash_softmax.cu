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
// operand) per edge and head, which come from device memory where the rows
// are random. Design:
//
//   * one team of G lanes (a power of two up to 32, at least the head's
//     columns up to 32) owns one (row, head) of a CSR: the destinations for
//     kernels a and b, the sources for kernel c. Lane j holds the columns j,
//     j + G, ... of the head, so a team's loads of one row are contiguous.
//     The teams of a warp take neighbouring (row, head) items, so the heads
//     of one row walk the same edges side by side;
//   * the team keeps its sums in registers: the running (m, l, acc) of the
//     forward, the row's gradient in the backward passes. Nothing per edge
//     is written to device memory and no sum takes an atomic;
//   * U edges' indices and rows are loaded before any of them is used, so U
//     gathers are in flight per lane (U = 4 for heads of up to 64 columns);
//   * a row of more than `split` edges is cut into pieces of `split` edges,
//     one team each (the hub rows of a power-law graph would otherwise hold
//     up a whole launch). A piece writes its partials to a scratch slot and
//     takes a ticket; the team that takes the last ticket merges the row's
//     partials in piece order and writes the row. So the result does not
//     depend on which team finishes last, and two launches give the same
//     bits (the ticket counters are the only atomics, and they add nothing
//     to a sum);
//   * the global reductions (GATv2's d att [H*F], the dot form's d p [R,
//     H]) are summed per team in registers or in the team's shared-memory
//     row, then per block in a fixed order into per-block partials, which
//     the wrapper sums in block order.
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
  float* gdot;                  // [N_dst, h]
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
  float slope;
};

namespace {

constexpr int kThreads = 256;
enum Form { kGat = 0, kGatV2 = 1, kDot = 2 };


__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

__device__ __forceinline__ unsigned team_mask(int g) {
  if (g == 32) return 0xffffffffu;
  const int lane = threadIdx.x & 31;
  return ((1u << g) - 1u) << (lane & ~(g - 1));
}

// The team's sum, the same bits in every lane (a fixed butterfly).
__device__ __forceinline__ float team_sum(float v, int g, unsigned mask) {
  for (int off = g >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// The row of piece p: the largest r with piece_ptr[r] <= p (every row has
// at least one piece, so piece_ptr rises strictly).
__device__ __forceinline__ long long find_row(const long long* piece_ptr,
                                              long long n_rows, long long p) {
  long long lo = 0, hi = n_rows;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(piece_ptr + mid) <= p)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// One team's item: (piece, head), its row and edge range.
struct Item {
  bool active;
  long long row, k, np, e0, e1;
  int head;
};

__device__ __forceinline__ Item team_item(const FlashArgs& a) {
  Item it;
  const long long item =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / a.g_lanes;
  const long long total = __ldg(a.piece_ptr + a.n_rows);
  it.active = item < total * a.h;
  it.row = it.k = it.np = it.e0 = it.e1 = 0;
  it.head = 0;
  if (it.active) {
    const long long p = item / a.h;
    it.head = (int)(item - p * a.h);
    it.row = find_row(a.piece_ptr, a.n_rows, p);
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

// A piece of a split row: publish the partials (written by the caller),
// take a ticket; true in every lane of the team that took the last one.
__device__ __forceinline__ bool last_piece(const FlashArgs& a, const Item& it,
                                           int sub, unsigned mask) {
  __threadfence();
  __syncwarp(mask);
  int last = 0;
  if (sub == 0) {
    const long long t = __ldg(a.split_base + it.row) * a.h + it.head;
    last = atomicAdd(a.tickets + t, 1) == (int)(it.np - 1);
  }
  last = __shfl_sync(mask, last, 0, a.g_lanes);
  if (last) __threadfence();
  return last != 0;
}

__device__ __forceinline__ long long slot_of(const FlashArgs& a,
                                             const Item& it, long long q) {
  return __ldg(a.split_base + it.row) + q;
}

// Edges in flight per lane: fewer for wide heads, whose rows fill registers.
template <int NV>
struct Unroll {
  static constexpr int value = NV <= 2 ? 4 : (NV <= 4 ? 2 : 1);
};

// -- kernel (a): the forward, destination-major --------------------------------
template <int FORM, int NV>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  constexpr int U = Unroll<NV>::value;
  const int G = a.g_lanes, C = a.c, H = a.h;
  const int sub = threadIdx.x & (G - 1);
  const unsigned mask = team_mask(G);
  const Item it = team_item(a);
  if (!it.active) return;
  const long long hc = (long long)H * C;
  const int hoff = it.head * C;

  // the row's operands
  float ad = 0.f, rowv[NV], at[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = sub + j * G;
    rowv[j] = at[j] = 0.f;
    if (FORM != kGat && col < C) {
      rowv[j] = __ldg(a.dst_tab + it.row * a.ld_dst + hoff + col);
      if (FORM == kGatV2) at[j] = __ldg(a.extra + hoff + col);
    }
  }
  if (FORM == kGat) ad = __ldg(a.dst_tab + it.row * a.ld_dst + it.head);

  float m = -INFINITY, l = 0.f, acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = 0.f;

  for (long long e = it.e0; e < it.e1; e += U) {
    long long s[U];
    float as[U], pr[U], kv[U][NV], vv[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = e + u < it.e1 ? (long long)__ldg(a.nbr + e + u) : -1;
      as[u] = pr[u] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) kv[u][j] = vv[u][j] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s[u] < 0) continue;
      if (FORM == kGat) as[u] = __ldg(a.src_tab + s[u] * a.ld_src + it.head);
      if (FORM == kDot)
        pr[u] = __ldg(a.extra + (long long)__ldg(a.rel + e + u) * H +
                      it.head);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = sub + j * G;
        if (col < C) {
          vv[u][j] = __ldg(a.val + s[u] * a.ld_val + hoff + col);
          if (FORM == kDot)
            kv[u][j] = __ldg(a.src_tab + s[u] * a.ld_src + hoff + col);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s[u] < 0) continue;  // the same in every lane of the team
      float logit;
      if (FORM == kGat) {
        logit = leaky(as[u] + ad, a.slope);
      } else if (FORM == kGatV2) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          t += at[j] * leaky(vv[u][j] + rowv[j], a.slope);
        logit = team_sum(t, G, mask);
      } else {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) t += rowv[j] * kv[u][j];
        logit = team_sum(t, G, mask) * pr[u];
      }
      if (logit > m) {
        const float sc = expf(m - logit);  // 0 while m = -inf
        l = l * sc + 1.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[j] = acc[j] * sc + vv[u][j];
        m = logit;
      } else {
        const float z = logit == -INFINITY ? 0.f : expf(logit - m);
        l += z;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[j] += z * vv[u][j];
      }
    }
  }

  if (it.np > 1) {
    const long long slot = slot_of(a, it, it.k);
    if (sub == 0) {
      a.part_s[slot * H + it.head] = m;
      a.part_s2[slot * H + it.head] = l;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = sub + j * G;
      if (col < C) a.part_v[slot * hc + hoff + col] = acc[j];
    }
    if (!last_piece(a, it, sub, mask)) return;
    // merge the row's partials in piece order
    m = -INFINITY;
    for (long long q = 0; q < it.np; ++q)
      m = fmaxf(m, __ldcg(a.part_s + slot_of(a, it, q) * H + it.head));
    l = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = 0.f;
    for (long long q = 0; q < it.np; ++q) {
      const long long sq = slot_of(a, it, q);
      const float mq = __ldcg(a.part_s + sq * H + it.head);
      const float w = mq == -INFINITY ? 0.f : expf(mq - m);
      l += __ldcg(a.part_s2 + sq * H + it.head) * w;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = sub + j * G;
        if (col < C) acc[j] += __ldcg(a.part_v + sq * hc + hoff + col) * w;
      }
    }
  }
  if (sub == 0) {
    a.m[it.row * H + it.head] = m;
    a.l[it.row * H + it.head] = l;
  }
  const float inv = 1.f / fmaxf(l, 1e-16f);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = sub + j * G;
    if (col < C) a.out[it.row * hc + hoff + col] = acc[j] * inv;
  }
}

// -- kernel (b): the backward's destination pass -------------------------------
// Per destination row: gdot = <g, out>, and d a_dst (gat), d x_r (gatv2) or
// d q (dot); GATv2's d att and the dot form's d p as per-block partials.
template <int FORM, int NV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dst_kernel(FlashArgs a) {
  constexpr int U = Unroll<NV>::value;
  extern __shared__ float smem[];
  const int G = a.g_lanes, C = a.c, H = a.h;
  const int sub = threadIdx.x & (G - 1);
  const int team = threadIdx.x / G, teams = kThreads / G;
  const unsigned mask = team_mask(G);
  const Item it = team_item(a);
  const long long hc = (long long)H * C;
  const int hoff = it.head * C;
  // this team's shared row for the global reduction
  float* sg = smem + (FORM == kGatV2 ? team * (G * NV) : team * a.n_rel);
  if (FORM == kDot && sub == 0)
    for (int r = 0; r < a.n_rel; ++r) sg[r] = 0.f;
  __syncwarp(mask);

  float glob[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) glob[j] = 0.f;

  if (it.active) {
    float gv[NV], rowv[NV], at[NV];
    float gd = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = sub + j * G;
      gv[j] = rowv[j] = at[j] = 0.f;
      if (col < C) {
        gv[j] = __ldg(a.g + it.row * hc + hoff + col);
        gd += gv[j] * __ldg(a.out + it.row * hc + hoff + col);
        if (FORM != kGat)
          rowv[j] = __ldg(a.dst_tab + it.row * a.ld_dst + hoff + col);
        if (FORM == kGatV2) at[j] = __ldg(a.extra + hoff + col);
      }
    }
    gd = team_sum(gd, G, mask);
    if (it.k == 0 && sub == 0) a.gdot[it.row * H + it.head] = gd;
    const float ad =
        FORM == kGat ? __ldg(a.dst_tab + it.row * a.ld_dst + it.head) : 0.f;
    const float mr = __ldg(a.m + it.row * H + it.head);
    const float ms = isfinite(mr) ? mr : 0.f;
    const float ls = fmaxf(__ldg(a.l + it.row * H + it.head), 1e-16f);

    float acc_s = 0.f, acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = 0.f;

    for (long long e = it.e0; e < it.e1; e += U) {
      long long s[U];
      int rl[U];
      float as[U], pr[U], kv[U][NV], vv[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = e + u < it.e1 ? (long long)__ldg(a.nbr + e + u) : -1;
        as[u] = pr[u] = 0.f;
        rl[u] = 0;
#pragma unroll
        for (int j = 0; j < NV; ++j) kv[u][j] = vv[u][j] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s[u] < 0) continue;
        if (FORM == kGat)
          as[u] = __ldg(a.src_tab + s[u] * a.ld_src + it.head);
        if (FORM == kDot) {
          rl[u] = __ldg(a.rel + e + u);
          pr[u] = __ldg(a.extra + (long long)rl[u] * H + it.head);
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int col = sub + j * G;
          if (col < C) {
            vv[u][j] = __ldg(a.val + s[u] * a.ld_val + hoff + col);
            if (FORM == kDot)
              kv[u][j] = __ldg(a.src_tab + s[u] * a.ld_src + hoff + col);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s[u] < 0) continue;
        float logit, base = 0.f;
        if (FORM == kGat) {
          base = as[u] + ad;
          logit = leaky(base, a.slope);
        } else if (FORM == kGatV2) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < NV; ++j)
            t += at[j] * leaky(vv[u][j] + rowv[j], a.slope);
          logit = team_sum(t, G, mask);
        } else {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < NV; ++j) t += rowv[j] * kv[u][j];
          base = team_sum(t, G, mask);
          logit = base * pr[u];
        }
        const float alpha = expf(logit - ms) / ls;
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) t += gv[j] * vv[u][j];
        const float dlogit = alpha * (team_sum(t, G, mask) - gd);
        if (FORM == kGat) {
          acc_s += base >= 0.f ? dlogit : a.slope * dlogit;
        } else if (FORM == kGatV2) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const float b = vv[u][j] + rowv[j];
            const float dj = dlogit * at[j];
            acc[j] += b >= 0.f ? dj : a.slope * dj;
            glob[j] += leaky(b, a.slope) * dlogit;
          }
        } else {
          if (sub == 0) sg[rl[u]] += dlogit * base;
          const float db = dlogit * pr[u];
#pragma unroll
          for (int j = 0; j < NV; ++j) acc[j] += db * kv[u][j];
        }
      }
    }

    bool write = true;
    if (it.np > 1) {
      const long long slot = slot_of(a, it, it.k);
      if (FORM == kGat && sub == 0) a.part_s[slot * H + it.head] = acc_s;
      if (FORM != kGat) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int col = sub + j * G;
          if (col < C) a.part_v[slot * hc + hoff + col] = acc[j];
        }
      }
      write = last_piece(a, it, sub, mask);
      if (write) {
        acc_s = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[j] = 0.f;
        for (long long q = 0; q < it.np; ++q) {
          const long long sq = slot_of(a, it, q);
          if (FORM == kGat) acc_s += __ldcg(a.part_s + sq * H + it.head);
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int col = sub + j * G;
            if (FORM != kGat && col < C)
              acc[j] += __ldcg(a.part_v + sq * hc + hoff + col);
          }
        }
      }
    }
    if (write) {
      if (FORM == kGat) {
        if (sub == 0) a.d_row[it.row * H + it.head] = acc_s;
      } else {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int col = sub + j * G;
          if (col < C) a.d_row[it.row * hc + hoff + col] = acc[j];
        }
      }
    }
  }

  if (FORM == kGat) return;
  // the block's partial of the global reduction, teams summed in order
  if (FORM == kGatV2) {
#pragma unroll
    for (int j = 0; j < NV; ++j) sg[sub + j * G] = it.active ? glob[j] : 0.f;
  }
  __syncthreads();
  const long long first = (long long)blockIdx.x * teams;
  const long long total = __ldg(a.piece_ptr + a.n_rows) * H;
  const int width = FORM == kGatV2 ? H * C : a.n_rel * H;
  for (int t = threadIdx.x; t < width; t += kThreads) {
    float sum = 0.f;
    if (FORM == kGatV2) {
      const int hh = t / C, cc = t - hh * C;
      for (int tb = 0; tb < teams; ++tb) {
        const long long item = first + tb;
        if (item < total && (int)(item % H) == hh)
          sum += smem[tb * (G * NV) + cc];
      }
    } else {
      const int r = t / H, hh = t - r * H;
      for (int tb = 0; tb < teams; ++tb) {
        const long long item = first + tb;
        if (item < total && (int)(item % H) == hh)
          sum += smem[tb * a.n_rel + r];
      }
    }
    a.d_glob[(long long)blockIdx.x * width + t] = sum;
  }
}

// -- kernel (c): the backward's source pass ------------------------------------
// Per source row: d a_src and d v (gat), d x_l (gatv2), d k and d v (dot).
template <int FORM, int NV>
__global__ void __launch_bounds__(kThreads) flash_bwd_src_kernel(FlashArgs a) {
  constexpr int U = Unroll<NV>::value;
  const int G = a.g_lanes, C = a.c, H = a.h;
  const int sub = threadIdx.x & (G - 1);
  const unsigned mask = team_mask(G);
  const Item it = team_item(a);
  if (!it.active) return;
  const long long hc = (long long)H * C;
  const int hoff = it.head * C;

  // the source row's operands
  float vs[NV], ks[NV], at[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = sub + j * G;
    vs[j] = ks[j] = at[j] = 0.f;
    if (col < C) {
      vs[j] = __ldg(a.val + it.row * a.ld_val + hoff + col);
      if (FORM == kDot)
        ks[j] = __ldg(a.src_tab + it.row * a.ld_src + hoff + col);
      if (FORM == kGatV2) at[j] = __ldg(a.extra + hoff + col);
    }
  }
  const float as =
      FORM == kGat ? __ldg(a.src_tab + it.row * a.ld_src + it.head) : 0.f;

  float acc_s = 0.f, acc[NV], acc2[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = acc2[j] = 0.f;

  for (long long e = it.e0; e < it.e1; e += U) {
    long long d[U];
    float ad[U], pr[U], mr[U], lr[U], gd[U], gv[U][NV], rv[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      d[u] = e + u < it.e1 ? (long long)__ldg(a.nbr + e + u) : -1;
      ad[u] = pr[u] = mr[u] = gd[u] = 0.f;
      lr[u] = 1.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) gv[u][j] = rv[u][j] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (d[u] < 0) continue;
      const long long dh = d[u] * H + it.head;
      mr[u] = __ldg(a.m + dh);
      lr[u] = __ldg(a.l + dh);
      gd[u] = __ldg(a.gdot + dh);
      if (FORM == kGat) ad[u] = __ldg(a.dst_tab + d[u] * a.ld_dst + it.head);
      if (FORM == kDot)
        pr[u] = __ldg(a.extra + (long long)__ldg(a.rel + e + u) * H +
                      it.head);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = sub + j * G;
        if (col < C) {
          gv[u][j] = __ldg(a.g + d[u] * hc + hoff + col);
          if (FORM != kGat)
            rv[u][j] = __ldg(a.dst_tab + d[u] * a.ld_dst + hoff + col);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (d[u] < 0) continue;
      float logit, base = 0.f;
      if (FORM == kGat) {
        base = as + ad[u];
        logit = leaky(base, a.slope);
      } else if (FORM == kGatV2) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          t += at[j] * leaky(vs[j] + rv[u][j], a.slope);
        logit = team_sum(t, G, mask);
      } else {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) t += rv[u][j] * ks[j];
        base = team_sum(t, G, mask);
        logit = base * pr[u];
      }
      const float ms = isfinite(mr[u]) ? mr[u] : 0.f;
      const float alpha = expf(logit - ms) / fmaxf(lr[u], 1e-16f);
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) t += gv[u][j] * vs[j];
      const float dlogit = alpha * (team_sum(t, G, mask) - gd[u]);
      if (FORM == kGat) {
        acc_s += base >= 0.f ? dlogit : a.slope * dlogit;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[j] += alpha * gv[u][j];
      } else if (FORM == kGatV2) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float dj = dlogit * at[j];
          const float db = vs[j] + rv[u][j] >= 0.f ? dj : a.slope * dj;
          acc[j] += db + alpha * gv[u][j];
        }
      } else {
        const float db = dlogit * pr[u];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          acc[j] += db * rv[u][j];
          acc2[j] += alpha * gv[u][j];
        }
      }
    }
  }

  if (it.np > 1) {
    const long long slot = slot_of(a, it, it.k);
    if (FORM == kGat && sub == 0) a.part_s[slot * H + it.head] = acc_s;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = sub + j * G;
      if (col < C) {
        a.part_v[slot * hc + hoff + col] = acc[j];
        if (FORM == kDot) a.part_v2[slot * hc + hoff + col] = acc2[j];
      }
    }
    if (!last_piece(a, it, sub, mask)) return;
    acc_s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = acc2[j] = 0.f;
    for (long long q = 0; q < it.np; ++q) {
      const long long sq = slot_of(a, it, q);
      if (FORM == kGat) acc_s += __ldcg(a.part_s + sq * H + it.head);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = sub + j * G;
        if (col < C) {
          acc[j] += __ldcg(a.part_v + sq * hc + hoff + col);
          if (FORM == kDot) acc2[j] += __ldcg(a.part_v2 + sq * hc + hoff + col);
        }
      }
    }
  }
  if (FORM == kGat && sub == 0) a.d_row[it.row * H + it.head] = acc_s;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = sub + j * G;
    if (col < C) {
      if (FORM == kGat) {
        a.d_val[it.row * hc + hoff + col] = acc[j];
      } else {
        a.d_row[it.row * hc + hoff + col] = acc[j];
        if (FORM == kDot) a.d_val[it.row * hc + hoff + col] = acc2[j];
      }
    }
  }
}

enum Pass { kFwd = 0, kBwdDst = 1, kBwdSrc = 2 };

template <int FORM, int NV>
cudaError_t launch_nv(int pass, const FlashArgs& a, cudaStream_t st) {
  const long long teams = kThreads / a.g_lanes;
  const long long blocks = (a.max_pieces * a.h + teams - 1) / teams;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (pass == kFwd) {
    flash_fwd_kernel<FORM, NV><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  } else if (pass == kBwdSrc) {
    flash_bwd_src_kernel<FORM, NV><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  } else {
    size_t smem = 0;
    if (FORM == kGatV2) smem = sizeof(float) * kThreads * NV;
    if (FORM == kDot) smem = sizeof(float) * teams * a.n_rel;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dst_kernel<FORM, NV>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    flash_bwd_dst_kernel<FORM, NV>
        <<<(unsigned)blocks, kThreads, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_form(int pass, const FlashArgs& a, cudaStream_t st) {
  // columns a lane holds: ceil(c / g), rounded up to a power of two
  const int per = (a.c + a.g_lanes - 1) / a.g_lanes;
  if (per <= 1) return launch_nv<FORM, 1>(pass, a, st);
  if (per <= 2) return launch_nv<FORM, 2>(pass, a, st);
  if (per <= 4) return launch_nv<FORM, 4>(pass, a, st);
  if (per <= 8) return launch_nv<FORM, 8>(pass, a, st);
  if (per <= 16) return launch_nv<FORM, 16>(pass, a, st);
  return cudaErrorInvalidValue;
}

int run(int pass, const FlashArgs* args, void* stream) {
  const FlashArgs& a = *args;
  const int g = a.g_lanes;
  if (a.h <= 0 || a.c <= 0 || g <= 0 || g > 32 || (g & (g - 1)) != 0 ||
      a.split <= 0 || a.n_rows < 0 || (a.form == kDot && a.n_rel <= 0))
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

// Kernel (b): gdot, the destination-side gradient, and the per-block
// partials of the global reduction (GATv2, dot), over the same CSR.
extern "C" int pgt_flash_bwd_dst(const FlashArgs* args, void* stream) {
  return run(kBwdDst, args, stream);
}

// Kernel (c): the source-side gradients over the source-major CSR (the
// destinations as neighbours); reads the gdot kernel (b) wrote.
extern "C" int pgt_flash_bwd_src(const FlashArgs* args, void* stream) {
  return run(kBwdSrc, args, stream);
}
