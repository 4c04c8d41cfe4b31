// Masked segment-max over destination-sorted slots, float32, for Hopper
// (sm_90a).
//
//   out[d, h] = max_{k = indptr[d]}^{indptr[d+1]-1} max(vals[k, h], -3.4e38)
//
// with -inf for a row that has no slot and for a maximum <= -3e38.
//
// Replaces the TPU kernel `_chunk_max_kernel` (pytorch_geometric_tpu/ops/
// pallas_spmm.py:327, launched at :384 by `segment_max_blocked`) together
// with its XLA segment-max epilogue and its output rule (:400). The TPU
// kernel selects a chunk's edges into 128-row windows with a one-hot mask
// and a masked broadcast, because a max has no MXU form; the sentinel
// -3.4e38 keeps 0 * -inf out of that arithmetic select. Here each row reads
// its own slots, so nothing is selected arithmetically; the sentinel stays
// only for the output rule, which callers rely on.
//
// Bound on the card: bytes. Each value is read once (S * H * 4 bytes), and
// indptr and the output once; one max per value is far below any compute
// rate. A row's slots are short (21 at the attention bench's graph), so what
// holds a kernel back is latency, not bandwidth: a whole warp per row would
// carry a few hundred bytes after a dependent indptr load. So:
//
//   * a group of `lanes` lanes (a power of two in [1, 32], picked by the
//     caller from the mean run length so that each lane reads 4-8 slots,
//     ops/segment_max.py::segment_max_lanes) owns one destination row, and
//     a warp serves 32 / lanes rows;
//   * a row's H-wide slots are one contiguous run vals[beg * H, end * H),
//     read in units of VEC floats: float4 (16-byte) loads where H % 4 == 0
//     and vals is 16-byte aligned (a whole slot per load at H = 4), scalars
//     otherwise. With U = H / VEC units per slot, the group's lanes stride
//     the run by P = (lanes / U) * U units, so a lane always sees the same
//     unit of every slot; the lanes of one unit then meet through
//     __shfl_down_sync, and the lanes of the first copy store. Where U >
//     lanes, each lane owns units l, l + lanes, ... and walks the row's
//     slots; nothing is lost on a row of any length, and no atomics are
//     used;
//   * a lane issues its loads four at a time before it takes their maxima,
//     so a row's loads are in flight together (at the mean run of 21
//     slots and 4 lanes, a lane's loads in two batches);
//   * the values take plain loads: streaming loads (ld.global.cs) read
//     them no faster and with a wider spread from call to call;
//   * the maximum propagates a NaN, as jnp.maximum does, and is otherwise
//     exact, so it is bitwise equal to any other order of the same maxima;
//   * the padded slots past indptr[n_dst] are never read, and a row's run is
//     clamped to [0, n_slots), so a malformed indptr reads nothing out of
//     bounds.
//
// Plain C interface, bound from Python with ctypes; every launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;

__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__device__ __forceinline__ float clamp_sentinel(float v) {
  return v < -3.4e38f ? -3.4e38f : v;
}

__device__ __forceinline__ float output_rule(float m) {
  return m <= -3e38f ? -__int_as_float(0x7f800000) : m;
}

template <int VEC>
__device__ __forceinline__ void load_unit(const float* p, float* x);

template <>
__device__ __forceinline__ void load_unit<4>(const float* p, float* x) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

template <>
__device__ __forceinline__ void load_unit<1>(const float* p, float* x) {
  x[0] = __ldg(p);
}

template <int VEC>
__device__ __forceinline__ void store_unit(float* p, const float* m);

template <>
__device__ __forceinline__ void store_unit<4>(float* p, const float* m) {
  *reinterpret_cast<float4*>(p) =
      make_float4(output_rule(m[0]), output_rule(m[1]), output_rule(m[2]),
                  output_rule(m[3]));
}

template <>
__device__ __forceinline__ void store_unit<1>(float* p, const float* m) {
  *p = output_rule(m[0]);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
segment_max_f32_kernel(const int* __restrict__ indptr,
                       const float* __restrict__ vals,
                       float* __restrict__ out, long long n_dst,
                       long long n_slots, int h, int lanes) {
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lanes;
  const int group = lane / lanes;
  const int gl = lane - group * lanes;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long row = warp * rows_per_warp + group;
  const bool live = row < n_dst;
  long long beg = 0, end = 0;
  if (live) {
    beg = min(max((long long)__ldg(indptr + row), 0LL), n_slots);
    end = max(min((long long)__ldg(indptr + row + 1), n_slots), beg);
  }
  const int units = h / VEC;  // VEC-wide units per slot

  if (units > lanes) {  // uniform across the warp: no shuffles below
    if (!live) return;
    for (int c = gl; c < units; c += lanes) {
      float acc[VEC], x[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = -3.4e38f;
      for (long long k = beg; k < end; ++k) {
        load_unit<VEC>(vals + (k * units + c) * VEC, x);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = max_nan(acc[i], clamp_sentinel(x[i]));
      }
      store_unit<VEC>(out + row * h + (long long)c * VEC, acc);
    }
    return;
  }

  const int copies = lanes / units;  // lanes that read the same unit
  const int period = copies * units;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = -3.4e38f;
  if (gl < period) {
    // kBatch loads in flight before any of their maxima; a load past the
    // run gives the sentinel, which changes no maximum
    const long long stop = end * units;
    for (long long i = beg * units + gl; i < stop; i += kBatch * period) {
      float xb[kBatch][VEC];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (i + b * period < stop) {
          load_unit<VEC>(vals + (i + b * period) * VEC, xb[b]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) xb[b][j] = -3.4e38f;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] = max_nan(acc[j], clamp_sentinel(xb[b][j]));
    }
  }
  // copy q of unit c is lane q * units + c of the group: a tree over the
  // copies, every lane of the warp taking part in each shuffle
  const int copy = gl / units;
  for (int d = 1; d < copies; d <<= 1) {
    const bool take = (copy & (2 * d - 1)) == 0 && copy + d < copies;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float other = __shfl_down_sync(0xffffffffu, acc[i], d * units);
      if (take) acc[i] = max_nan(acc[i], other);
    }
  }
  if (live && gl < units) store_unit<VEC>(out + row * h + gl * VEC, acc);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// indptr [n_dst + 1] int32, vals [n_slots, h] float32 row-major, out
// [n_dst, h] float32; lanes_per_row a power of two in [1, 32]. Runs on
// `stream` and does not synchronise. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for another lanes_per_row.
extern "C" int pgt_segment_max_f32(const void* indptr, const void* vals,
                                   void* out, long long n_dst,
                                   long long n_slots, int h,
                                   int lanes_per_row, void* stream) {
  const int g = lanes_per_row;
  if (g < 1 || g > 32 || (g & (g - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_dst <= 0 || h <= 0) return (int)cudaSuccess;
  const long long rows_per_block = (kThreads / 32) * (32 / g);
  const long long blocks = (n_dst + rows_per_block - 1) / rows_per_block;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const float* vp = static_cast<const float*>(vals);
  float* op = static_cast<float*>(out);
  if (h % 4 == 0 && aligned(vals, 16) && aligned(out, 16))
    segment_max_f32_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(
        ip, vp, op, n_dst, n_slots, h, g);
  else
    segment_max_f32_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(
        ip, vp, op, n_dst, n_slots, h, g);
  return (int)cudaGetLastError();
}
