// Hopper tensor-core tile helpers shared by the bf16 attention kernels
// (flash_fwd.cu K1, flash_bwd.cu K3, lsh_attend_bwd.cu K5).
//
// Products run on mma.sync.m16n8k16 (bf16 operands, f32 accumulators).  A
// warp owns 16 rows of a block's tile.  Operands come from bf16 tiles in
// shared memory whose rows are padded by 16 bytes (kLd = DH + 8 values),
// so the eight rows an ldmatrix reads hit distinct banks; tiles arrive by
// 16-byte cp.async.  An accumulator fragment holds, for lane l (g = l / 4,
// t4 = l % 4), c0/c1 at row g and c2/c3 at row g + 8, columns 2 t4 and
// 2 t4 + 1 of its 8-column n-tile: masks and hashes act on it at those
// coordinates, and acc_to_a turns two n-tiles into the A operand of the
// next product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src must still be a
// valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lane l addresses one row
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, lo in the low half (the lower column of a pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 as the sum of two bf16 pairs: hi = bf16(x), lo = bf16(x - hi),
// which keeps 16 of f32's 24 mantissa bits
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The A operand (16 x 16, row-major) of a k-step from two accumulator
// tiles of 16 x 8 (columns 0-7 in c0, 8-15 in c1), as hi + lo bf16
// operands: two products with the same B give the f32 accumulator's
// product to about 2^-16, where one bf16 rounding (2^-9) would not hold
// the bf16 tolerance on sums that cancel.
__device__ __forceinline__ void acc_to_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const float (&c0)[4], const float (&c1)[4]) {
  split_bf16(hi[0], lo[0], c0[0], c0[1]);
  split_bf16(hi[1], lo[1], c0[2], c0[3]);
  split_bf16(hi[2], lo[2], c1[0], c1[1]);
  split_bf16(hi[3], lo[3], c1[2], c1[3]);
}

// the same A operand rounded to bf16 once
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// smem offsets (in bf16) of lane's row address for ldmatrix x4:
//   a_off: the A operand of rows r0..r0+15, columns c0..c0+15 (also B
//          through .trans from a (k, n) row-major tile: k rows r0.., n
//          columns c0..c0+15, giving two 8-column n-tiles);
//   b_off: B operands of two n-tiles from an (n, k) row-major tile: n rows
//          r0..r0+15, k columns c0..c0+15 (no .trans).
template <int LD>
__device__ __forceinline__ int a_off(int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off(int r0, int c0, int lane) {
  return (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8;
}

// ROWS rows from r0 of a (n, DH) bf16 tensor into a padded smem tile, zeros
// past n, by 16-byte cp.async from THREADS threads (the caller commits)
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int r0, int n,
                                                int tid) {
  constexpr int kChunks = DH / 8, kLd = DH + 8;
  static_assert(ROWS * kChunks % THREADS == 0, "tile not a multiple of the block");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i / kChunks, ch = i % kChunks, g = r0 + r;
    const bool valid = g < n;
    cp_async16(dst + r * kLd + ch * 8, src + (size_t)(valid ? g : 0) * DH + ch * 8, valid);
  }
}

// s (16 x NC f32) = A B^T for a warp: A's rows a_r0..a_r0+15 and B's rows
// 0..NC-1 of two (rows, DH) row-major smem tiles with row stride DH + 8
template <int DH, int NC>
__device__ __forceinline__ void warp_abt(float (&s)[NC / 8][4], const bf16* a_tile, int a_r0,
                                         const bf16* b_tile, int lane) {
  constexpr int kLd = DH + 8;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_tile + a_off<kLd>(a_r0, 16 * kk, lane));
#pragma unroll
    for (int j = 0; j < NC / 16; ++j) {
      uint32_t b[4];
      ldsm_x4(b, b_tile + b_off<kLd>(16 * j, 16 * kk, lane));
      mma_bf16(s[2 * j], a, b[0], b[1]);
      mma_bf16(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DH f32) += X B for a warp: X (16 x NK) from accumulator tiles,
// as hi + lo bf16 operands when LO, else rounded once; B's rows 0..NK-1 of
// a (rows, DH) row-major smem tile with row stride DH + 8 (ldmatrix.trans)
template <int DH, int NK, bool LO>
__device__ __forceinline__ void warp_acc_xb(float (&acc)[DH / 8][4], const float (&x)[NK / 8][4],
                                            const bf16* b_tile, int lane) {
  constexpr int kLd = DH + 8;
#pragma unroll
  for (int kc = 0; kc < NK / 16; ++kc) {
    uint32_t hi[4], lo[4];
    if constexpr (LO) {
      acc_to_a(hi, lo, x[2 * kc], x[2 * kc + 1]);
    } else {
      acc_to_a(hi, x[2 * kc], x[2 * kc + 1]);
    }
#pragma unroll
    for (int nd = 0; nd < DH / 16; ++nd) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_tile + a_off<kLd>(16 * kc, 16 * nd, lane));
      mma_bf16(acc[2 * nd], hi, b[0], b[1]);
      mma_bf16(acc[2 * nd + 1], hi, b[2], b[3]);
      if constexpr (LO) {
        mma_bf16(acc[2 * nd], lo, b[0], b[1]);
        mma_bf16(acc[2 * nd + 1], lo, b[2], b[3]);
      }
    }
  }
}

// Rows r0 and r0 + 8 of a (rows, DH) bf16 tensor from this lane's DH / 8
// accumulator tiles (row r0 = the warp's first row + lane / 4), scaled per
// row, rounded to bf16; rows at or past n are not written.
template <int DH>
__device__ __forceinline__ void store_acc_rows(bf16* dst, const float (&acc)[DH / 8][4], int r0,
                                               int n, const float (&scale)[2], int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * DH + 8 * nd + 2 * t4) =
          pack_bf16(acc[nd][2 * h] * scale[h], acc[nd][2 * h + 1] * scale[h]);
  }
}

// exp(x) as 2^(x log2 e) on the SFU: within a few ulp of expf in fewer
// instructions; x = 0 gives exactly 1 and x = -inf exactly 0.  The caller
// subtracts the max first, so x log2 e rounds at the scale of x, not of
// the scores (-1e9 masks would lose every digit otherwise).
__device__ __forceinline__ float exp_fast(float x) { return exp2f(x * 1.4426950408889634f); }

// x reduced over the four lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// What the runtime reports of a kernel on this card at a block of
// `threads` and `smem` dynamic shared bytes: out[0..3] = registers a
// thread, local (spill) bytes a thread, the shared bytes, blocks an SM.
template <typename Kernel>
cudaError_t kernel_resources(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace
