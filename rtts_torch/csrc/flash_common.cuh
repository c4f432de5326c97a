// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Mask values and the attention-dropout hash follow the TPU kernels in
// rtts/ops/flash_attention.py bit for bit, so the forward, both backward
// kernels and the plain PyTorch versions draw the same keep mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e9f;       // MASK_VALUE of the Python side
constexpr float kSelfMaskValue = -1e5f;   // SELF_MASK_VALUE

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// lowbias32 avalanche finalizer (_mix32 of the TPU kernel)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Keep bit of one attention probability (_keep_tile): the top 24 bits of
// the hash of (row, col, bh, seed), wrapping mod 2^32, against the
// threshold round(keep_prob * 2^24).
__device__ __forceinline__ bool keep(uint32_t seed, int bh, int row, int col, int drop_thr) {
  const uint32_t u = (uint32_t)row * 0x85EBCA6Bu + (uint32_t)col * 0xC2B2AE35u +
                     (uint32_t)bh * 0x27D4EB2Fu + seed;
  return (int)(mix32(u) >> 8) < drop_thr;
}

// keep / keep_prob: the factor dropout puts on one probability
__device__ __forceinline__ float drop_rscale(uint32_t seed, int bh, int row, int col,
                                             int drop_thr, float drop_scale) {
  return keep(seed, bh, row, col, drop_thr) ? drop_scale : 0.f;
}

// The masked f32 score of (query position qpos, key gk): replace-style masks
// in the order of the TPU kernel's _apply_masks.  mv: 1 valid key, 0 pad,
// -1 past the end of the sequence (left out of the softmax: -inf).
__device__ __forceinline__ float mask_score(float x, int mv, int qpos, int gk, int causal,
                                            int self_mask) {
  if (mv == 0) x = kMaskValue;
  if (causal && qpos < gk) x = kMaskValue;
  if (self_mask && qpos == gk) x = kSelfMaskValue;
  if (mv < 0) x = -INFINITY;
  return x;
}

// key validity: 1 valid, 0 pad, -1 past the end
__device__ __forceinline__ int key_state(const uint8_t* kv_mask, int b, int gk, int lk) {
  return gk >= lk ? -1 : (kv_mask == nullptr ? 1 : (kv_mask[(size_t)b * lk + gk] != 0));
}

}  // namespace
