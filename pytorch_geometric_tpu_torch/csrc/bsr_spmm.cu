// Block-sparse (BSR) SpMM over cached 128x128 adjacency blocks, for Hopper
// (sm_90a): float32 blocks (`pgt_bsr_spmm_f32`) and bfloat16 blocks on the
// tensor cores (`pgt_bsr_spmm_bf16`, at the end of this file).
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

#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// The bf16 arm: the TPU kernel's bf16 branch (pytorch_geometric_tpu/ops/
// bsr_spmm.py:129-140, blocks stored bf16 by fill_cache(cache_dtype=bf16),
// edge_index.py:444-451), one MXU pass of bf16 blocks times x rounded to bf16
// with float32 accumulation, the result float32. Here that pass runs on the
// tensor cores, `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`: a
// product of two bf16 values is exact in float32, so this is the same sum in
// another order.
//
//   * One CTA per (dst block row, F tile of FT = 16, 32 or 64 columns) loops
//     over the row's blocks through `row_ptr`, as the float32 kernel does; its
//     8 warps each own 16 output rows x FT columns in float32 fragments, and
//     each output tile is written once, with no atomics.
//   * Per block: the 32 KB bf16 value block is copied with 16-byte `cp.async`
//     into shared memory (rows padded to 136 bf16, so the fragment loads of a
//     warp hit 32 distinct banks), and the 128 x FT x tile is read as float32,
//     rounded to bf16 (`__floats2bfloat162_rn`, the round-to-nearest-even of
//     `astype`) with zeros past n_src and f, and stored transposed (column n
//     holds its 128 k values contiguous), which is the layout of the mma's
//     "col" B fragment. Then 8 k-steps of 16.
//   * Two blocks are in flight: the next block's values are copied while the
//     current block's products run (about 100 KB of shared memory at FT = 64,
//     so two CTAs share an SM).
//
// Bound on the card: bytes. At path E's F = 64 (39,439 blocks of 32 KB: 1.29
// GB per layout, plus 64 MB of x and 64 MB of out) the least time is about
// (1.29 + 0.064 + 0.064) GB / 3.35 TB/s = 0.42 ms; the 2 * NB * 128^2 * F =
// 82.7 GFLOP the dense blocks take run at 989 TFLOP/s in about 0.08 ms. x
// tiles are re-read once per block (as in the float32 kernel) and come mostly
// from L2. Simple and right first: TMA and wgmma are later work.

namespace {

constexpr int LDH = BS + 8;  // bf16 per staged row: 272 bytes, 16-byte aligned

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c[0..3] += A (16 x 16, row-major fragment a[0..3]) * B (16 x 8, "col"
// fragment b[0..1]), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int FT>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_bf16_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ cols,
                     const __nv_bfloat16* __restrict__ vals,
                     const float* __restrict__ x, float* __restrict__ out,
                     long long num_out, long long n_src, long long f,
                     long long nb) {
  constexpr int NT = FT / 8;  // m16n8 tiles across a warp's FT columns
  extern __shared__ float4 smem4[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem4);  // [2][BS][LDH]
  __nv_bfloat16* Bs = As + 2 * BS * LDH;  // [2][FT][LDH], Bs[n][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and pair
  const long long rb = blockIdx.x;
  const long long f0 = (long long)blockIdx.y * FT;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const long long kbeg = max((long long)__ldg(row_ptr + rb), 0LL);
  const long long kend = min((long long)__ldg(row_ptr + rb + 1), nb);

  // value block k into buffer buf: 2048 chunks of 16 bytes, 16 to a row
  auto stage_a = [&](long long k, int buf) {
    const char* src = reinterpret_cast<const char*>(vals + k * BS * BS);
    __nv_bfloat16* dst = As + buf * BS * LDH;
#pragma unroll
    for (int q = 0; q < (BS * BS / 8) / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      cp_async16(dst + (idx >> 4) * LDH + 8 * (idx & 15),
                 src + (size_t)idx * 16);
    }
  };
  // x tile of block k into buffer buf, transposed, two k values a word
  auto stage_b = [&](long long k, int buf) {
    const long long s0 = (long long)__ldg(cols + k) * BS;
    __nv_bfloat16* dst = Bs + buf * FT * LDH;
#pragma unroll 4
    for (int idx = tid; idx < FT * (BS / 2); idx += kThreads) {
      const int n = idx % FT, kp = idx / FT;
      const long long s = s0 + 2 * kp, col = f0 + n;
      float lo = 0.f, hi = 0.f;
      if (col < f) {
        if (s < n_src) lo = __ldg(x + s * f + col);
        if (s + 1 < n_src) hi = __ldg(x + (s + 1) * f + col);
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + n * LDH + 2 * kp) =
          __floats2bfloat162_rn(lo, hi);
    }
  };

  if (kbeg < kend) {
    stage_a(kbeg, 0);
    cp_async_commit();
    stage_b(kbeg, 0);
  }
  for (long long k = kbeg; k < kend; ++k) {
    const int cur = (int)((k - kbeg) & 1);
    if (k + 1 < kend) {
      stage_a(k + 1, cur ^ 1);  // its buffer was last read before the sync
      cp_async_commit();        // that ended the previous iteration
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block k's values and x tile are in shared memory

    const __nv_bfloat16* A = As + cur * BS * LDH + warp * 16 * LDH;
    const __nv_bfloat16* B = Bs + cur * FT * LDH;
#pragma unroll
    for (int kk = 0; kk < BS; kk += 16) {
      uint32_t a[4];
      a[0] = ld_pair(A + g * LDH + kk + 2 * t);
      a[1] = ld_pair(A + (g + 8) * LDH + kk + 2 * t);
      a[2] = ld_pair(A + g * LDH + kk + 8 + 2 * t);
      a[3] = ld_pair(A + (g + 8) * LDH + kk + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* bj = B + (j * 8 + g) * LDH + kk + 2 * t;
        const uint32_t b[2] = {ld_pair(bj), ld_pair(bj + 8)};
        mma_bf16(acc[j], a, b);
      }
    }
    if (k + 1 < kend) stage_b(k + 1, cur ^ 1);
    __syncthreads();  // buffer cur is consumed before it is refilled
  }

  // c[0], c[1]: row g, columns 2t, 2t + 1; c[2], c[3]: row g + 8
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const long long col = f0 + j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = rb * BS + warp * 16 + g + 8 * h;
      if (row >= num_out) continue;
      if (col < f) out[row * f + col] = acc[j][2 * h];
      if (col + 1 < f) out[row * f + col + 1] = acc[j][2 * h + 1];
    }
  }
}

template <int FT>
cudaError_t launch_bf16(const int* row_ptr, const int* cols,
                        const __nv_bfloat16* vals, const float* x, float* out,
                        long long n_row_blocks, long long num_out,
                        long long n_src, long long f, long long nb,
                        cudaStream_t stream) {
  const size_t smem = (size_t)2 * (BS + FT) * LDH * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_bf16_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_row_blocks, (unsigned)((f + FT - 1) / FT));
  bsr_spmm_bf16_kernel<FT><<<grid, kThreads, smem, stream>>>(
      row_ptr, cols, vals, x, out, num_out, n_src, f, nb);
  return cudaGetLastError();
}

}  // namespace

// As pgt_bsr_spmm_f32, with vals [nb, 128, 128] bfloat16 (16-byte aligned);
// x stays float32 and is rounded to bf16 on the way in, out is float32.
extern "C" int pgt_bsr_spmm_bf16(const void* row_ptr, const void* cols,
                                 const void* vals, const void* x, void* out,
                                 long long n_row_blocks, long long num_out,
                                 long long n_src, long long f, long long nb,
                                 void* stream) {
  if (n_row_blocks <= 0 || num_out <= 0 || f <= 0) return (int)cudaSuccess;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* cp = static_cast<const int*>(cols);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(vals);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaError_t err;
  if (f <= 16)
    err = launch_bf16<16>(rp, cp, vp, xp, op, n_row_blocks, num_out, n_src,
                          f, nb, s);
  else if (f <= 32)
    err = launch_bf16<32>(rp, cp, vp, xp, op, n_row_blocks, num_out, n_src,
                          f, nb, s);
  else
    err = launch_bf16<64>(rp, cp, vp, xp, op, n_row_blocks, num_out, n_src,
                          f, nb, s);
  return (int)err;
}
