// Block-sparse (BSR) SpMM over cached 128x128 adjacency blocks, float32, for
// Hopper (sm_90a).
//
//   out[r*128 + i, :] = sum_{k = row_ptr[r]}^{row_ptr[r+1]-1}
//                       sum_{j < 128} vals[k, i, j] * x[cols[k]*128 + j, :]
//
// Replaces the TPU kernel `_make_kernel` (pytorch_geometric_tpu/ops/
// bsr_spmm.py:114, launched at :184 by `_bsr_matmul_impl`, forward and, over
// the transposed layout, backward). The TPU kernel walks a sequential grid
// (f_tiles, NB) and carries each dst row's sum in its resident output tile,
// zeroed on the row's `first` block. Hopper CTAs run in no order and carry
// nothing, so:
//
//   * one CTA owns one (dst block row, F tile) and loops over that row's
//     blocks through `row_ptr` (built once at fill_cache time), keeping the
//     128 x FT output tile in registers; it writes the tile once, with no
//     atomics, so the result is deterministic; a row with no blocks writes
//     zeros (the JAX layout's spliced zero blocks are not needed);
//   * F is tiled by FT = 16, 32 or 64 columns (the smallest that covers a
//     narrow F), and the ragged F edge, the ragged last node block and
//     sources past n_src are masked, instead of padding F to 128 (which at
//     F = 10 would multiply the work by 12.8);
//   * exact float32: plain FMAs on the CUDA cores. TF32 tensor cores keep
//     about three decimal digits, and the TPU kernel's f32 arm is HIGHEST.
//
// Per block the CTA stages the 64 KB value block (rows padded to 132 floats,
// so the two row groups of a warp read disjoint banks) and the 128 x FT x
// tile in shared memory, then each of its 256 threads accumulates an 8 x TN
// micro-tile (rows ty + 16m, columns tx*TN .. tx*TN+TN-1), reading four A
// values per 16-byte shared load. About 100 KB of shared memory per CTA lets
// two CTAs share an SM, so one loads while the other computes.
//
// Bound on the card: the bytes, the NB * 64 KB block stream plus x and out
// over 3.35 TB/s. The function needs 2 * (nonzeros in the blocks) * F FLOPs,
// far fewer; this kernel multiplies every stored zero too, 2 * NB * 128^2 * F
// FLOPs, which over the 67 TFLOP/s of the CUDA cores sets its own floor above
// the byte bound at F = 64. Measured times are in PERF.md.
//
// Plain C interface, bound from Python with ctypes; every launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;
constexpr int kThreads = 256;
constexpr int LDA = BS + 4;  // floats per staged value-block row

template <int TN>
__device__ __forceinline__ void load_b(const float* p, float* b);

template <>
__device__ __forceinline__ void load_b<1>(const float* p, float* b) {
  b[0] = p[0];
}

template <>
__device__ __forceinline__ void load_b<2>(const float* p, float* b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  b[0] = t.x;
  b[1] = t.y;
}

template <>
__device__ __forceinline__ void load_b<4>(const float* p, float* b) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  b[0] = t.x;
  b[1] = t.y;
  b[2] = t.z;
  b[3] = t.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// TN columns per thread; the CTA's F tile is FT = 16 * TN columns wide.
template <int TN>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_f32_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ cols,
                    const float* __restrict__ vals,
                    const float* __restrict__ x, float* __restrict__ out,
                    long long num_out, long long n_src, long long f,
                    long long nb, bool vec4) {
  constexpr int FT = 16 * TN;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [BS][LDA]
  float* Bs = As + BS * LDA;                    // [BS][FT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group
  const int ty = tid >> 4;  // row group: rows ty + 16m
  const long long rb = blockIdx.x;
  const long long f0 = (long long)blockIdx.y * FT;

  float acc[8][TN];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  const long long kbeg = max((long long)__ldg(row_ptr + rb), 0LL);
  const long long kend = min((long long)__ldg(row_ptr + rb + 1), nb);

  for (long long k = kbeg; k < kend; ++k) {
    const long long s0 = (long long)__ldg(cols + k) * BS;
    const float4* a4 = reinterpret_cast<const float4*>(vals + k * BS * BS);
    __syncthreads();  // the previous block's tiles are consumed
    // value block: 4096 float4, a warp reads one 512-byte row; streamed
    // once, so evict-first in L2 to leave room for x
#pragma unroll 4
    for (int q = 0; q < (BS * BS / 4) / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      *reinterpret_cast<float4*>(As + (idx >> 5) * LDA + 4 * (idx & 31)) =
          __ldcs(a4 + idx);
    }
    // x tile: rows s0 .. s0+127, columns f0 .. f0+FT-1, zero past the edges
    if (vec4) {
      constexpr int V = FT / 4;
      for (int idx = tid; idx < BS * V; idx += kThreads) {
        const int r = idx / V, c = idx % V;
        const long long s = s0 + r, col = f0 + 4 * c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s < n_src && col < f)
          v = __ldg(reinterpret_cast<const float4*>(x + s * f + col));
        *reinterpret_cast<float4*>(Bs + r * FT + 4 * c) = v;
      }
    } else {
      for (int idx = tid; idx < BS * FT; idx += kThreads) {
        const int r = idx / FT, c = idx % FT;
        const long long s = s0 + r, col = f0 + c;
        Bs[r * FT + c] = (s < n_src && col < f) ? __ldg(x + s * f + col) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BS; j += 4) {
      float4 a[8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
        a[m] = *reinterpret_cast<const float4*>(As + (ty + 16 * m) * LDA + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[TN];
        load_b<TN>(Bs + (j + q) * FT + tx * TN, b);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float av = lane_of(a[m], q);
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(av, b[n], acc[m][n]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const long long row = rb * BS + ty + 16 * m;
    if (row >= num_out) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const long long col = f0 + tx * TN + n;
      if (col < f) out[row * f + col] = acc[m][n];
    }
  }
}

template <int TN>
cudaError_t launch(const int* row_ptr, const int* cols, const float* vals,
                   const float* x, float* out, long long n_row_blocks,
                   long long num_out, long long n_src, long long f,
                   long long nb, bool vec4, cudaStream_t stream) {
  constexpr int FT = 16 * TN;
  const size_t smem = (size_t)(BS * LDA + BS * FT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_f32_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_row_blocks, (unsigned)((f + FT - 1) / FT));
  bsr_spmm_f32_kernel<TN><<<grid, kThreads, smem, stream>>>(
      row_ptr, cols, vals, x, out, num_out, n_src, f, nb, vec4);
  return cudaGetLastError();
}

}  // namespace

// row_ptr [n_row_blocks + 1] int32 (the blocks of dst block row r are
// row_ptr[r] .. row_ptr[r+1]-1), cols [nb] int32 (src block of each block),
// vals [nb, 128, 128] float32 (vals[k, d_local, s_local]), x [n_src, f]
// float32 row-major, out [num_out, f] float32 with num_out <= 128 *
// n_row_blocks. vals must be 16-byte aligned. Runs on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launch.
extern "C" int pgt_bsr_spmm_f32(const void* row_ptr, const void* cols,
                                const void* vals, const void* x, void* out,
                                long long n_row_blocks, long long num_out,
                                long long n_src, long long f, long long nb,
                                void* stream) {
  if (n_row_blocks <= 0 || num_out <= 0 || f <= 0) return (int)cudaSuccess;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* cp = static_cast<const int*>(cols);
  const float* vp = static_cast<const float*>(vals);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  // 16-byte x loads need a row stride of whole float4s and an aligned base
  const bool vec4 = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (f <= 16)
    err = launch<1>(rp, cp, vp, xp, op, n_row_blocks, num_out, n_src, f, nb,
                    vec4, s);
  else if (f <= 32)
    err = launch<2>(rp, cp, vp, xp, op, n_row_blocks, num_out, n_src, f, nb,
                    vec4, s);
  else
    err = launch<4>(rp, cp, vp, xp, op, n_row_blocks, num_out, n_src, f, nb,
                    vec4, s);
  return (int)err;
}
