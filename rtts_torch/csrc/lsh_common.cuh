// Shared pieces of the LSH chunk-attend kernels: K4's bf16 forward
// (lsh_attend_fwd.cu) and K5's dQ kernel (lsh_attend_bwd.cu), whose first
// pass is K4's whole function.
//
// A block owns one query chunk i of c rows (c / 16 warps, 16 rows a warp).
// Its window is the key chunks (i + o - before) mod nc for o in [0, n_off),
// n_off = before + 1 + after; the chunk index wraps over the whole chunk
// axis, so a chunk may appear twice (nc 1 and 2).  The window's K and V are
// staged whole in shared memory, bf16 rows padded to DH + 8 values
// (mma_tiles.cuh), with each key's original position and validity.
#pragma once

#include <math.h>

#include "mma_tiles.cuh"

namespace {

__device__ __forceinline__ int wrap_chunk(int x, int nc) { return ((x % nc) + nc) % nc; }

// The masked score of (query position qp, key position kp, key validity kv)
// in the order of the TPU kernels: invalid key and causal q_pos < k_pos
// replace it by mask_value, the self entry (even an invalid key) by
// self_mask_value.  A: the launch's arguments (causal, mask_value,
// self_mask_value).
template <typename A>
__device__ __forceinline__ float lsh_mask(float x, int kv, int qp, int kp, const A& a) {
  if (!kv) x = a.mask_value;
  if (a.causal && qp < kp) x = a.mask_value;
  if (qp == kp) x = a.self_mask_value;
  return x;
}

// The window of query chunk i of batch*head n into ks, vs (n_off x C x
// (DH + 8)) by cp.async from THREADS threads (the caller commits), and the
// keys' positions and validity into kpos_s, kval_s (n_off x C).
template <int DH, int C, int THREADS>
__device__ __forceinline__ void load_window(bf16* ks, bf16* vs, int* kpos_s, int* kval_s,
                                            const bf16* k, const bf16* v, const int* pos,
                                            const uint8_t* valid, int n, int nc, int i,
                                            int before, int n_off, int tid) {
  constexpr int kLd = DH + 8;
  for (int o = 0; o < n_off; ++o) {
    const size_t key0 = ((size_t)n * nc + wrap_chunk(i + o - before, nc)) * C;
    load_tile_async<DH, C, THREADS>(ks + o * C * kLd, k + key0 * DH, 0, C, tid);
    load_tile_async<DH, C, THREADS>(vs + o * C * kLd, v + key0 * DH, 0, C, tid);
    for (int c = tid; c < C; c += THREADS) {
      kpos_s[o * C + c] = pos[key0 + c];
      kval_s[o * C + c] = valid[key0 + c];
    }
  }
}

// One warp's 16 query rows (from row 16 warp of the staged queries qs)
// against the staged window, online over its offsets: S = Q K^T in f32,
// masked on the accumulator fragments, the joint row max m and this lane's
// part of the row sum l (the caller reduces l over the quad), and O = P V
// unnormalised, P = exp(S - m) entering P V as hi + lo bf16 operands when
// LO, else rounded to bf16 once.  qpos: the positions of this lane's rows
// (16 warp + lane / 4 and 8 more).
template <int DH, int C, bool LO, typename A>
__device__ __forceinline__ void window_softmax_pv(float (&acc)[DH / 8][4], float (&m)[2],
                                                  float (&l)[2], const bf16* qs, const bf16* ks,
                                                  const bf16* vs, const int* kpos_s,
                                                  const int* kval_s, const int (&qpos)[2],
                                                  int n_off, const A& a, int warp, int lane) {
  constexpr int kLd = DH + 8, kNT = C / 8, kDT = DH / 8;
  const int t4 = lane & 3;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  for (int o = 0; o < n_off; ++o) {
    float s[kNT][4];
    warp_abt<DH, C>(s, qs, 16 * warp, ks + o * C * kLd, lane);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = o * C + 8 * j + 2 * t4 + (e & 1);
        s[j][e] = lsh_mask(s[j][e], kval_s[c], qpos[h], kpos_s[c], a);
        tmax[h] = fmaxf(tmax[h], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(tmax[h]));
      alpha[h] = exp_fast(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int d = 0; d < kDT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp_fast(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
    warp_acc_xb<DH, C, LO>(acc, s, vs + o * C * kLd, lane);
  }
}

}  // namespace
