// Block-sparse (BSR) SpMM over cached 128x128 adjacency blocks, for Hopper
// (sm_90a), both arms on the tensor cores through `wgmma`: float32 blocks
// (`pgt_bsr_spmm_f32`, a 3xTF32 split) and bfloat16 blocks
// (`pgt_bsr_spmm_bf16`, one bf16 pass).
//
//   out[r*128 + i, :] = sum_{k = row_ptr[r]}^{row_ptr[r+1]-1}
//                       sum_{j < 128} vals[k, i, j] * x[cols[k]*128 + j, :]
//
// Replaces the TPU kernel `_make_kernel` (pytorch_geometric_tpu/ops/
// bsr_spmm.py:114, launched at :184 by `_bsr_matmul_impl`, forward and, over
// the transposed layout, backward; its bf16 branch at :129-140). The TPU
// kernel walks a sequential grid and carries each dst row's sum in its
// resident output tile. Here:
//
//   * A pre-pass (`bsr_prep_kernel`) lays x out once per call as the main
//     kernel reads it: per 128-row source tile, per F tile of FT columns
//     and per K-chunk, one contiguous run holding the `wgmma` B operand in
//     its K-major, unswizzled core-matrix layout ([k group][n][16 B]),
//     F padded to FT and rows past n_src zeroed; float32 x as TF32 `x_hi`
//     and `x_lo` (`cvt.rna`), bf16 as x rounded to nearest even (what the
//     JAX package's `x.astype(bf16)` does). It also zeroes the row counter.
//   * One persistent CTA per SM takes work items (dst block row, F tile)
//     from that counter, in the order `order` gives: the rows by descending
//     block count, so the longest rows start first and the short ones fill
//     the tail. Each output row is written once by one CTA, with no atomics
//     on the output, so the result is deterministic.
//   * The CTA is one producer thread (a warp of its own) and two consumer
//     warpgroups. The producer keeps a ring of stages in shared memory full
//     with TMA copies that complete on `mbarrier`s: a stage is a K-chunk of
//     one block, 256 bytes of each of its 128 rows (64 float32 columns,
//     half a block; or a whole bf16 block), as two tensor-map boxes of 128
//     rows by 128 bytes with the 128-byte swizzle, so the consumers'
//     16-byte fragment loads of 8 rows hit distinct banks; plus the chunk's
//     x run, one `cp.async.bulk`. Three copies a chunk: the first design
//     copied each 256-byte row on its own (129 copies a chunk) and was
//     bound by starting the copies, at 0.94 TB/s. The values are streamed
//     once (L2 evict-first); x runs are re-read by every block of their source
//     tile and come mostly from L2. A small header in each stage tells the
//     consumers the row, the F tile, and whether the chunk ends the row.
//     The tensor map comes from cuTensorMapEncodeTiled, looked up
//     through the runtime, so the library links no libcuda.
//   * Each consumer warpgroup owns 64 of the block's 128 rows and runs
//     `wgmma.m64nFTk8` (TF32) or `k16` (bf16) with A, the block values, from
//     registers and B, the x run, from shared memory. Both operands must be
//     K-major for TF32; the values are K-major already. A thread loads its
//     A fragments as 16-byte vectors: the K order inside a chunk is
//     permuted (`perm` below) so that one vector holds what a thread needs
//     for two k-steps, and the pre-pass applies the same permutation to x,
//     so the sum is unchanged.
//   * float32: each value v is split in registers, hi = cvt.rna.tf32(v),
//     lo = cvt.rna.tf32(v - hi), and each k-step runs hi*x_hi, hi*x_lo
//     and lo*x_hi, which keeps about 22 bits of each product (one TF32 pass
//     keeps 11). The tensor cores need not round to nearest when they add
//     into their accumulator, so each chunk's products go to a fresh
//     accumulator (24 updates at most) that is then added to the row's
//     float32 sum with ordinary FADDs: even with every update truncated the
//     error stays within 1e-5 of the row's sum of |a*x|, the limit the
//     kernel is held to (tests/test_torch_bsr_plan.py emulates it).
//   * bf16: one pass, bf16 blocks times x rounded to bf16, float32
//     accumulation per block as above.
//
// Bound on the card: the bytes (the NB * 64 KB, or 32 KB, block stream plus
// x and out over 3.35 TB/s). The dense blocks take 3 * 2 * NB * 128^2 * FT
// TF32 FLOPs (495 TFLOP/s) or 2 * NB * 128^2 * FT bf16 ones (989), below
// the bytes at the paths' F. Measured times are in PERF.md.
//
// Plain C interface, bound from Python with ctypes; every entry point
// returns cudaGetLastError() after its launches. The launch plan (FT, the
// number of stages) comes from the caller (`ops/bsr_spmm.py::bsr_plan`).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;
constexpr int ROW_BYTES = 256;  // one staged run of a block row
constexpr int BOX_BYTES = 128;  // the TMA box's row: one 128-byte swizzle span
constexpr int VALS_STAGE = BS * ROW_BYTES;
constexpr int HEAD_BYTES = 1024;  // barriers and headers, before the ring
constexpr int MAX_STAGES = 8;
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;

enum : int { kLast = 1, kEmpty = 2, kEnd = 4 };

struct Header {
  int row, ft, flags, pad;
};

// float32 blocks: 64-column chunks, two per block, x as TF32 hi and lo
struct F32Arm {
  using T = float;
  static constexpr int KC = 64, CPB = 2, HL = 2, EPU = 4;
  // logical k (8 per k-step) -> column of the chunk
  static __host__ __device__ int perm(int l) {
    const int step = l >> 3, j = l & 7;
    return 16 * (step >> 1) + 4 * (j & 3) + 2 * (step & 1) + (j >> 2);
  }
};

// bf16 blocks: the whole block is one 128-column chunk, x as bf16
struct Bf16Arm {
  using T = __nv_bfloat16;
  static constexpr int KC = 128, CPB = 1, HL = 1, EPU = 8;
  // logical k (16 per k-step) -> column of the chunk
  static __host__ __device__ int perm(int l) {
    const int step = l >> 4, j = l & 15;
    return 32 * (step >> 1) + 8 * ((j & 7) >> 1) + 4 * (step & 1) +
           2 * (j >> 3) + (j & 1);
  }
};

template <class Arm, int FT>
__host__ __device__ constexpr int x_chunk_bytes() {
  return Arm::HL * Arm::KC * FT * (int)sizeof(typename Arm::T);
}

template <class Arm, int FT>
__host__ __device__ constexpr int stage_bytes() {
  return VALS_STAGE + x_chunk_bytes<Arm, FT>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// `bytes` (a multiple of 16) from global to shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the box of `map` at (column c0, row c1) to shared memory, completing on
// `bar`, with the L2 policy `pol`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar,
                                         uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "l"(pol)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void pin(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// A K-major, unswizzled shared-memory operand: core matrices of 8 rows x 16
// bytes, `lbo` bytes apart along K and `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x N float32, the warpgroup's fragments) = or += A (64 x K, four
// registers a thread) * B (K x N in shared memory, descriptor b); `acc`
// zero overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// One chunk's A fragments for the thread's two rows, r = g and r + 8 of
// its warp's 16: 16-byte unit U = 4p + t of each 256-byte chunk row, the
// vector p holding k-steps 2p, 2p + 1. The chunk lies in two 16 KB TMA
// boxes of 128-byte rows, unit u of row r at (u ^ (r % 8)) (the 128-byte
// swizzle), so the 8 rows of a warp's loads fall on distinct banks.
__device__ __forceinline__ void load_rows(const unsigned char* vals, int r,
                                          int t, uint4 (&v)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int row = r + 8 * h, u = 4 * (p & 1) + t;
      v[h][p] = *reinterpret_cast<const uint4*>(
          vals + (p >> 1) * (BS * BOX_BYTES) + row * BOX_BYTES +
          ((u ^ (row & 7)) << 4));
    }
}

// The consumers' work on one staged chunk: d = this chunk's A * B.
template <int FT>
__device__ __forceinline__ void chunk_f32(const unsigned char* vals, int r,
                                          int t, uint32_t xb, float* d) {
  constexpr uint32_t LBO = FT / 8 * 128, HALF = FT * F32Arm::KC * 4;
  uint4 v[2][4];
  load_rows(vals, r, t, v);
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      // a0: row g, a1: row g + 8, a2 / a3 the same rows four k later
      const uint32_t raw[4] = {word(v[0][p], 2 * sb), word(v[1][p], 2 * sb),
                               word(v[0][p], 2 * sb + 1),
                               word(v[1][p], 2 * sb + 1)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = __uint_as_float(raw[i]);
        ah[2 * p + sb][i] = tf32_rna(a);
        al[2 * p + sb][i] = tf32_rna(a - __uint_as_float(ah[2 * p + sb][i]));
      }
    }
  wg_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t off = 2 * s * LBO;
    const uint64_t bh = desc(xb + off, LBO, 128);
    const uint64_t bl = desc(xb + HALF + off, LBO, 128);
    Wgmma<FT>::tf32(d, ah[s], bh, s);
    Wgmma<FT>::tf32(d, ah[s], bl, 1);
    Wgmma<FT>::tf32(d, al[s], bh, 1);
  }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int i = 0; i < FT / 2; ++i) pin(d[i]);
}

template <int FT>
__device__ __forceinline__ void chunk_bf16(const unsigned char* vals, int r,
                                           int t, uint32_t xb, float* d) {
  constexpr uint32_t LBO = FT / 8 * 128;
  uint4 v[2][4];
  load_rows(vals, r, t, v);
  uint32_t a[8][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      a[2 * p + sb][0] = word(v[0][p], 2 * sb);
      a[2 * p + sb][1] = word(v[1][p], 2 * sb);
      a[2 * p + sb][2] = word(v[0][p], 2 * sb + 1);
      a[2 * p + sb][3] = word(v[1][p], 2 * sb + 1);
    }
  wg_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    Wgmma<FT>::bf16(d, a[s], desc(xb + 2 * s * LBO, LBO, 128), s);
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int i = 0; i < FT / 2; ++i) pin(d[i]);
}

template <class Arm, int FT>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_kernel(const __grid_constant__ CUtensorMap vals,
                const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const int* __restrict__ order,
                const typename Arm::T* __restrict__ xs,
                float* __restrict__ out, int* __restrict__ counter,
                int n_items, int n_ft, long long num_out, long long f,
                long long nb, int stages) {
  using T = typename Arm::T;
  constexpr int XB = x_chunk_bytes<Arm, FT>();
  constexpr int SB = stage_bytes<Arm, FT>();
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * MAX_STAGES;
  Header* headers = reinterpret_cast<Header*>(smem + 16 * MAX_STAGES);
  unsigned char* ring = smem + HEAD_BYTES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // -- the producer: one thread --------------------------------------------
    if (lane != 0) return;
    const uint64_t pol = evict_first_policy();
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      const int item = atomicAdd(counter, 1);
      if (item >= n_items) break;
      const int r = __ldg(order + item / n_ft), ft = item % n_ft;
      const long long kb = max((long long)__ldg(row_ptr + r), 0LL);
      const long long ke = max(min((long long)__ldg(row_ptr + r + 1), nb), kb);
      const int nch = (int)(ke - kb) * Arm::CPB;
      for (int c = 0; c < max(nch, 1); ++c) {
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        headers[stage] = {r, ft,
                          (c == max(nch, 1) - 1 ? kLast : 0) |
                              (nch == 0 ? kEmpty : 0),
                          0};
        if (nch == 0) {
          mbar_arrive(full);
        } else {
          const long long k = kb + c / Arm::CPB;
          const int part = c % Arm::CPB;
          const uint32_t dst = smem_u32(ring + (size_t)stage * SB);
          mbar_expect_tx(full, VALS_STAGE + XB);
          // two boxes of 128 rows x 128 bytes: the chunk's 256-byte rows
          constexpr int BOX_COLS = BOX_BYTES / (int)sizeof(T);
#pragma unroll
          for (int b = 0; b < 2; ++b)
            tma_load(dst + b * BS * BOX_BYTES, &vals,
                     part * Arm::KC + b * BOX_COLS, (int)(k * BS), full, pol);
          const size_t chunk =
              ((size_t)__ldg(cols + k) * n_ft + ft) * Arm::CPB + part;
          bulk_copy(dst + VALS_STAGE,
                    reinterpret_cast<const char*>(xs) + chunk * XB, XB, full);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    headers[stage].flags = kEnd;
    mbar_arrive(full0 + 8 * stage);
  } else {
    // -- the consumer warpgroups ---------------------------------------------
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int row_in_block = wg * 64 + (warp & 3) * 16 + g;  // and + 8
    float total[FT / 2], d[FT / 2];
#pragma unroll
    for (int i = 0; i < FT / 2; ++i) total[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full0 + 8 * stage, phase);
      const Header h = headers[stage];
      if (h.flags & kEnd) break;
      if (!(h.flags & kEmpty)) {
        const unsigned char* base = ring + (size_t)stage * SB;
        const uint32_t xb = smem_u32(base + VALS_STAGE);
        if constexpr (Arm::HL == 2)
          chunk_f32<FT>(base, row_in_block, t, xb, d);
        else
          chunk_bf16<FT>(base, row_in_block, t, xb, d);
#pragma unroll
        for (int i = 0; i < FT / 2; ++i) total[i] += d[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (h.flags & kLast) {
        // d[4j + 2h + e]: row g + 8h, column 8j + 2t + e
        const long long col0 = (long long)h.ft * FT + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = (long long)h.row * BS + row_in_block + 8 * hh;
          if (row >= num_out) continue;
          float* o = out + row * f;
#pragma unroll
          for (int j = 0; j < FT / 8; ++j) {
            const long long col = col0 + 8 * j;
            const float v0 = total[4 * j + 2 * hh];
            const float v1 = total[4 * j + 2 * hh + 1];
            if (col + 1 < f && (f & 1) == 0) {
              *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
            } else {
              if (col < f) o[col] = v0;
              if (col + 1 < f) o[col + 1] = v1;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < FT / 2; ++i) total[i] = 0.f;
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

__device__ __forceinline__ void store_unit(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_unit(__nv_bfloat16* p, const float* v) {
  uint4 w;
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  const __nv_bfloat162 c = __floats2bfloat162_rn(v[4], v[5]);
  const __nv_bfloat162 e = __floats2bfloat162_rn(v[6], v[7]);
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  w.z = *reinterpret_cast<const uint32_t*>(&c);
  w.w = *reinterpret_cast<const uint32_t*>(&e);
  *reinterpret_cast<uint4*>(p) = w;
}

// The pre-pass: one thread per 16-byte unit of the laid-out x, index
// [source tile][F tile][chunk][hi/lo][k group][n][EPU k values]; also
// zeroes the row counter the main kernel takes its work from.
template <class Arm, int FT>
__global__ void __launch_bounds__(256)
bsr_prep_kernel(const float* __restrict__ x, typename Arm::T* __restrict__ xs,
            long long n_src, long long f, long long n_units, int n_ft,
            int* __restrict__ counter) {
  constexpr int EPU = Arm::EPU, KG = Arm::KC / EPU;
  constexpr int PER_CHUNK = Arm::HL * KG * FT;
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u == 0) *counter = 0;
  if (u >= n_units) return;
  const long long chunk = u / PER_CHUNK;
  const int w = (int)(u % PER_CHUNK);
  const int hl = w / (KG * FT), kg = (w / FT) % KG, nn = w % FT;
  const int part = (int)(chunk % Arm::CPB);
  const long long ft = (chunk / Arm::CPB) % n_ft;
  const long long tile = chunk / ((long long)Arm::CPB * n_ft);
  const long long n = ft * FT + nn;
  float v[EPU];
#pragma unroll
  for (int e = 0; e < EPU; ++e) {
    const long long s =
        tile * BS + part * Arm::KC + Arm::perm(kg * EPU + e);
    float a = (s < n_src && n < f) ? __ldg(x + s * f + n) : 0.f;
    if constexpr (Arm::HL == 2) {
      const float hi = __uint_as_float(tf32_rna(a));
      a = hl ? __uint_as_float(tf32_rna(a - hi)) : hi;
    }
    v[e] = a;
  }
  store_unit(xs + u * EPU, v);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the library
// links no libcuda); null where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return (EncodeTiled) nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of the blocks, a [nb * 128, 128] matrix, in boxes of 128
// rows by 128 bytes, 128-byte swizzled; nb = 0 leaves it zero (no copy
// reads it).
template <class Arm>
cudaError_t vals_map(CUtensorMap* map, const void* vals, long long nb) {
  *map = CUtensorMap{};
  if (nb == 0) return cudaSuccess;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  using T = typename Arm::T;
  const cuuint64_t dims[2] = {BS, (cuuint64_t)nb * BS};
  const cuuint64_t strides[1] = {BS * sizeof(T)};
  const cuuint32_t box[2] = {BOX_BYTES / sizeof(T), BS};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(vals), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Arm, int FT>
cudaError_t launch(const int* row_ptr, const int* cols, const int* order,
                   const void* vals, const float* x, void* xs, float* out,
                   int* counter, long long n_row_blocks, long long num_out,
                   long long n_src, long long f, long long nb, int stages,
                   cudaStream_t stream) {
  using T = typename Arm::T;
  const int n_ft = (int)((f + FT - 1) / FT);
  const long long tiles = (n_src + BS - 1) / BS;
  const long long n_units =
      tiles * n_ft * Arm::CPB *
      (long long)(Arm::HL * (Arm::KC / Arm::EPU) * FT);
  const long long prep_blocks = n_units > 0 ? (n_units + 255) / 256 : 1;
  bsr_prep_kernel<Arm, FT><<<(unsigned)prep_blocks, 256, 0, stream>>>(
      x, static_cast<T*>(xs), n_src, f, n_units, n_ft, counter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a refused call also leaves its error as the thread's last error: take
  // it, so that it is reported once, here, and not by a later launch
  const int smem = HEAD_BYTES + stages * stage_bytes<Arm, FT>();
  err = cudaFuncSetAttribute(bsr_spmm_kernel<Arm, FT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return cudaGetLastError(), err;
  CUtensorMap map;
  err = vals_map<Arm>(&map, vals, nb);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return cudaGetLastError(), err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return cudaGetLastError(), err;
  const long long n_items = n_row_blocks * n_ft;
  const int grid = (int)(n_items < sms ? n_items : sms);
  bsr_spmm_kernel<Arm, FT><<<grid, kThreads, smem, stream>>>(
      map, row_ptr, cols, order, static_cast<const T*>(xs), out, counter,
      (int)n_items, n_ft, num_out, f, nb, stages);
  return cudaGetLastError();
}

template <class Arm>
int run(const void* row_ptr, const void* cols, const void* order,
        const void* vals, const void* x, void* xs, void* out, void* counter,
        long long n_row_blocks, long long num_out, long long n_src,
        long long f, long long nb, int ft, int stages, void* stream) {
  if (n_row_blocks <= 0 || num_out <= 0 || f <= 0) return (int)cudaSuccess;
  if (stages < 2 || stages > MAX_STAGES || n_row_blocks * ((f + 15) / 16) >
                                               0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* cp = static_cast<const int*>(cols);
  const int* op = static_cast<const int*>(order);
  const float* xp = static_cast<const float*>(x);
  float* outp = static_cast<float*>(out);
  int* ctr = static_cast<int*>(counter);
  cudaError_t err;
  switch (ft) {
    case 16:
      err = launch<Arm, 16>(rp, cp, op, vals, xp, xs, outp, ctr, n_row_blocks,
                            num_out, n_src, f, nb, stages, s);
      break;
    case 32:
      err = launch<Arm, 32>(rp, cp, op, vals, xp, xs, outp, ctr, n_row_blocks,
                            num_out, n_src, f, nb, stages, s);
      break;
    case 64:
      err = launch<Arm, 64>(rp, cp, op, vals, xp, xs, outp, ctr, n_row_blocks,
                            num_out, n_src, f, nb, stages, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// row_ptr [n_row_blocks + 1] int32 (the blocks of dst block row r are
// row_ptr[r] .. row_ptr[r+1]-1), cols [nb] int32 (src block of each block),
// order [n_row_blocks] int32 (the rows in the order they are taken), vals
// [nb, 128, 128] float32 (vals[k, d_local, s_local], 16-byte aligned), x
// [n_src, f] float32 row-major (any alignment), xs the pre-pass's scratch
// (ceil(n_src / 128) * ceil(f / ft) * 1024 * ft bytes, 16-byte aligned),
// out [num_out, f] float32 with num_out <= 128 * n_row_blocks, counter one
// int32 of scratch. ft in {16, 32, 64} is the F tile, stages the ring's
// depth (2 .. 8). Runs on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launches.
extern "C" int pgt_bsr_spmm_f32(const void* row_ptr, const void* cols,
                                const void* order, const void* vals,
                                const void* x, void* xs, void* out,
                                void* counter, long long n_row_blocks,
                                long long num_out, long long n_src,
                                long long f, long long nb, int ft, int stages,
                                void* stream) {
  return run<F32Arm>(row_ptr, cols, order, vals, x, xs, out, counter,
                     n_row_blocks, num_out, n_src, f, nb, ft, stages, stream);
}

// As pgt_bsr_spmm_f32, with vals [nb, 128, 128] bfloat16; x stays float32
// and is rounded to bf16 by the pre-pass (xs: a quarter of the bytes), out
// is float32.
extern "C" int pgt_bsr_spmm_bf16(const void* row_ptr, const void* cols,
                                 const void* order, const void* vals,
                                 const void* x, void* xs, void* out,
                                 void* counter, long long n_row_blocks,
                                 long long num_out, long long n_src,
                                 long long f, long long nb, int ft,
                                 int stages, void* stream) {
  return run<Bf16Arm>(row_ptr, cols, order, vals, x, xs, out, counter,
                      n_row_blocks, num_out, n_src, f, nb, ft, stages,
                      stream);
}
