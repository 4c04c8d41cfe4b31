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
//   * one warp per destination row, no atomics: a row's H-wide slots are
//     one contiguous run vals[beg * H, end * H), which the warp's lanes read
//     with a stride of P = (32 / H) * H, so lane l always sees head l % H;
//     the lanes of one head then meet in shared memory. For H > 32 each
//     lane owns heads l, l + 32, ... and walks the row's slots;
//   * the maximum propagates a NaN, as jnp.maximum does, and is otherwise
//     exact, so it is bitwise equal to any other order of the same maxima;
//   * the padded slots past indptr[n_dst] are never read, and a row's run is
//     clamped to [0, n_slots), so a malformed indptr reads nothing out of
//     bounds.
//
// Bound on the card: bytes. Each value is read once (S * H * 4 bytes), and
// indptr and the output once; one max per value is far below any compute
// rate.
//
// Plain C interface, bound from Python with ctypes; every launch returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__device__ __forceinline__ float clamp_sentinel(float v) {
  return v < -3.4e38f ? -3.4e38f : v;
}

__device__ __forceinline__ float output_rule(float m) {
  return m <= -3e38f ? -__int_as_float(0x7f800000) : m;
}

__global__ void __launch_bounds__(kThreads)
segment_max_f32_kernel(const int* __restrict__ indptr,
                       const float* __restrict__ vals,
                       float* __restrict__ out, long long n_dst,
                       long long n_slots, int h) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + wib;
  if (row >= n_dst) return;  // whole warps leave together
  const long long beg =
      min(max((long long)__ldg(indptr + row), 0LL), n_slots);
  const long long end =
      max(min((long long)__ldg(indptr + row + 1), n_slots), beg);

  if (h > 32) {
    for (int c = lane; c < h; c += 32) {
      float acc = -3.4e38f;
      for (long long k = beg; k < end; ++k)
        acc = max_nan(acc, clamp_sentinel(__ldg(vals + k * h + c)));
      out[row * h + c] = output_rule(acc);
    }
    return;
  }
  const int groups = 32 / h;  // lanes per head
  const int p = groups * h;   // stride over the row's flat run
  float acc = -3.4e38f;
  if (lane < p) {
    for (long long i = beg * h + lane; i < end * h; i += p)
      acc = max_nan(acc, clamp_sentinel(__ldg(vals + i)));
  }
  part[wib][lane] = acc;
  __syncwarp();
  if (lane < h) {
    float m = part[wib][lane];
    for (int g = 1; g < groups; ++g) m = max_nan(m, part[wib][lane + g * h]);
    out[row * h + lane] = output_rule(m);
  }
}

}  // namespace

// indptr [n_dst + 1] int32, vals [n_slots, h] float32 row-major, out
// [n_dst, h] float32. Runs on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int pgt_segment_max_f32(const void* indptr, const void* vals,
                                   void* out, long long n_dst,
                                   long long n_slots, int h, void* stream) {
  if (n_dst <= 0 || h <= 0) return (int)cudaSuccess;
  const long long blocks = (n_dst + kWarps - 1) / kWarps;
  segment_max_f32_kernel<<<(unsigned)blocks, kThreads, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const float*>(vals),
      static_cast<float*>(out), n_dst, n_slots, h);
  return (int)cudaGetLastError();
}
