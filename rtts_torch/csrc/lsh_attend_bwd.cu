// LSH chunk-attend backward for Hopper, sm_90a: kernel K5.
//
// Replaces the TPU kernel rtts/ops/lsh_attention.py::_attend_bwd_kernel
// (launched by _attend_bwd_pallas_raw from the custom_vjp's _bwd_rule).
// Given K4's inputs (lsh_attend_fwd.cu) and the cotangents dO of the output
// and dlse of the logsumexp, it recomputes the joint softmax of each query
// chunk over its window of before + 1 + after chunks and forms
//
//   P   = softmax(s_masked)                 over all window offsets at once
//   dP  = dO V^T,   D = rowsum(dP o P)
//   dS  = P o (dP - D) + P o dlse,   0 on the self entries (q_pos == k_pos:
//         the score there is a replaced constant, so it has no derivative)
//   dQ  = dS K,   dK = dS^T Q,   dV = P^T dO   (dV keeps the self entries)
//
// The dlse term is needed: the multi-round combine weights each round by
// exp(lse - logsumexp(lse)), so gradients reach lse.  The softmax is
// normalised by its own joint max and sum, not taken as exp(s - lse), so a
// row left with only its self entries at -1e5 keeps exact probabilities.
//
// Design: FA2's split into two kernels, deterministic, no atomics, and no
// per-offset partial of dK or dV in device memory.
//   (a) the dQ kernel, one block per (batch*head, query chunk i): the joint
//       max m and sum l of each row over the window (online), D, then dQ,
//       written once; it also writes m, l and D - dlse of each row as f32
//       (the stats, 12 bytes a row).
//   (b) the dK/dV kernel, one block per (batch*head, key chunk j): it owns
//       dK and dV of chunk j and walks the window offsets o in order; the
//       query chunk (j - o + before) mod nc reaches j at offset o.  With the
//       stats it recomputes P = exp(s - m) / l exactly, with keys as rows,
//       and writes dK and dV once.
//
// What bounds it on this card: at the longform decoder shape (n 16, nc 512,
// c 64, dh 64, window 128 keys, bf16) the function moves 0.47 GB (0.14 ms
// at 3.35 TB/s) and does five products of 8.6 GFLOP each (0.04 ms at 989
// TFLOP/s): by the roofline HBM bounds it.  The kernels read their inputs
// about twice (each window is staged once per query chunk and once per
// key chunk, mostly from L2) and run thirteen products, not five (S twice,
// P V for D, and every product that takes P or dS twice, hi and lo), with
// the masks and exp per element beside them; at c 64 a block is four
// warps, and the registers set how many share an SM.  Two paths:
//
// bf16 (every config with LSH; c 16, 32 or 64): tensor-core products
// (mma_tiles.cuh), c / 16 warps a block, 16 rows a warp.  Each block copies
// its own rows and its whole window (K and V, or Q and dO, of every offset)
// into shared memory by cp.async once, so the two passes of the dQ kernel
// reread nothing from HBM.  The dQ kernel's first pass computes S = Q K^T
// and, online, m, l and O = P V; D = rowsum(dO o O) / l (the same sum as
// rowsum(dP o P)), so its second pass computes dP = dO V^T once per (row,
// key) and turns it into dS in registers.  The dK/dV kernel computes S^T =
// K Q^T and dP^T = V dO^T with keys as rows (queries in steps of 32, to
// stay in registers), so P^T and dS^T are A operands of dV += P^T
// dO and dK += dS^T Q.  P (for O and dV) and dS (for dQ and dK) enter their
// products as hi + lo bf16 operands (hi = bf16(x), lo = bf16(x - hi)): dQ and
// dK sum terms that cancel, and one bf16 rounding of dS misses the port's
// bf16 tolerance against the f32 plain backward
// (tests/test_torch_tc_rounding.py).  The TPU kernel computes in f32 and
// rounds only each offset's dK and dV.
//
// f32 (the card-vs-CPU checks): the same two kernels as f32 FMAs through
// shared memory, four threads a row: the dQ kernel keeps every offset's
// scores and then probabilities of its chunk in shared memory (joint max,
// then sum, then D, then dS and dQ), the dK/dV kernel forms P and dS of
// one offset at a time.  Full f32 products: TF32 would not hold the f32
// tolerance.

#include "lsh_common.cuh"

namespace {

constexpr int kTPR = 4;           // threads per row on the f32 path

struct BwdArgs {
  const void *q, *k, *v;
  const int* pos;
  const uint8_t* valid;
  const void* dout;
  const float* dlse;
  void *dq, *dk, *dv;
  float* stats;  // (3, n, nc, c): m, l, D - dlse of every query row
  int n, nc, causal, before, after;
  float mask_value, self_mask_value;
};

// ---- the bf16 tensor-core path ----------------------------------------------

// At dh 64 each kernel's registers are capped so that four blocks share
// an SM (at c 64 its shared memory allows four too); the dK/dV kernel takes
// 32 queries a step to fit the cap.  At dh 128 a cap would spill.
constexpr int kMinBlocks64 = 4;
constexpr int kQStep = 32;  // queries a step of the dK/dV kernel

template <int DH, int C>
size_t mma_smem_bytes(int n_off) {
  return sizeof(bf16) * (size_t)(2 + 2 * n_off) * C * (DH + 8) +
         sizeof(float) * (size_t)4 * n_off * C;
}

// (a) Block (query chunk i, batch*head n): dQ and the stats of its rows.
template <int DH, int C>
__global__ void __launch_bounds__(2 * C, DH == 64 ? kMinBlocks64 : 1)
    lsh_bwd_dq_mma_kernel(BwdArgs a) {
  constexpr int kThreads = 2 * C, kLd = DH + 8, kNT = C / 8, kDT = DH / 8;
  const int n_off = a.before + 1 + a.after;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // C x kLd, this block's queries
  bf16* dos = qs + C * kLd;                      // C x kLd, their dO
  bf16* ks = dos + C * kLd;                      // n_off x C x kLd, the window's keys
  bf16* vs = ks + n_off * C * kLd;               // n_off x C x kLd
  int* kpos_s = reinterpret_cast<int*>(vs + n_off * C * kLd);  // n_off x C
  int* kval_s = kpos_s + n_off * C;                           // n_off x C

  const int n = blockIdx.y, i = blockIdx.x, nc = a.nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const size_t row0 = ((size_t)n * nc + i) * C;

  load_tile_async<DH, C, kThreads>(qs, q + row0 * DH, 0, C, tid);
  load_tile_async<DH, C, kThreads>(dos, static_cast<const bf16*>(a.dout) + row0 * DH, 0, C, tid);
  load_window<DH, C, kThreads>(ks, vs, kpos_s, kval_s, k, v, a.pos, a.valid, n, nc, i, a.before,
                               n_off, tid);
  cp_async_commit();
  const int qr = 16 * warp + g;  // this thread's rows qr and qr + 8
  const int qpos[2] = {a.pos[row0 + qr], a.pos[row0 + qr + 8]};
  cp_async_wait<0>();
  __syncthreads();

  // pass 1: S, the rows' joint max and sum (online), O = P V unnormalised
  // (K4's function, lsh_common.cuh)
  float m[2], l[2], acc[kDT][4];
  window_softmax_pv<DH, C, true>(acc, m, l, qs, ks, vs, kpos_s, kval_s, qpos, n_off, a, warp,
                                 lane);

  // D = rowsum(dO o O) / l, the stats, and dd = D - dlse
  float inv_l[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv_l[h] = 1.f / l[h];
    float dsum = 0.f;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      const float2 dov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          dos + (qr + 8 * h) * kLd + 8 * d + 2 * t4));
      dsum += acc[d][2 * h] * dov.x + acc[d][2 * h + 1] * dov.y;
    }
    dd[h] = quad_sum(dsum) * inv_l[h] - a.dlse[row0 + qr + 8 * h];
  }
  if (t4 == 0) {
    const size_t rows = (size_t)a.n * nc * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = row0 + qr + 8 * h;
      a.stats[r] = m[h];
      a.stats[rows + r] = l[h];
      a.stats[2 * rows + r] = dd[h];
    }
  }

  // pass 2: dP = dO V^T once per (row, key), dS in registers, dQ += dS K
  float dq[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  for (int o = 0; o < n_off; ++o) {
    float s[kNT][4], dp[kNT][4];
    warp_abt<DH, C>(s, qs, 16 * warp, ks + o * C * kLd, lane);
    warp_abt<DH, C>(dp, dos, 16 * warp, vs + o * C * kLd, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = o * C + 8 * j + 2 * t4 + (e & 1);
        const float x = lsh_mask(s[j][e], kval_s[c], qpos[h], kpos_s[c], a);
        const float p = exp_fast(x - m[h]) * inv_l[h];
        dp[j][e] = qpos[h] == kpos_s[c] ? 0.f : p * (dp[j][e] - dd[h]);
      }
    }
    warp_acc_xb<DH, C, true>(dq, dp, ks + o * C * kLd, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_acc_rows<DH>(static_cast<bf16*>(a.dq) + row0 * DH, dq, qr, C, one, lane);
}

// (b) Block (key chunk j, batch*head n): dK and dV of the chunk.
template <int DH, int C>
__global__ void __launch_bounds__(2 * C, DH == 64 ? kMinBlocks64 : 1)
    lsh_bwd_dkv_mma_kernel(BwdArgs a) {
  constexpr int kThreads = 2 * C, kLd = DH + 8, kDT = DH / 8;
  constexpr int kQB = C < kQStep ? C : kQStep;
  constexpr int kNT = kQB / 8;
  const int n_off = a.before + 1 + a.after;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // C x kLd, this block's keys
  bf16* vs = ks + C * kLd;                       // C x kLd
  bf16* qs = vs + C * kLd;                       // n_off x C x kLd, the queries reaching them
  bf16* dos = qs + n_off * C * kLd;              // n_off x C x kLd, their dO
  int* qpos_s = reinterpret_cast<int*>(dos + n_off * C * kLd);  // n_off x C
  float* m_s = reinterpret_cast<float*>(qpos_s + n_off * C);     // n_off x C
  float* il_s = m_s + n_off * C;                                 // n_off x C: 1 / l
  float* dd_s = il_s + n_off * C;                                // n_off x C: D - dlse

  const int n = blockIdx.y, jc = blockIdx.x, nc = a.nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const size_t key0 = ((size_t)n * nc + jc) * C;
  const size_t rows = (size_t)a.n * nc * C;

  load_tile_async<DH, C, kThreads>(ks, static_cast<const bf16*>(a.k) + key0 * DH, 0, C, tid);
  load_tile_async<DH, C, kThreads>(vs, static_cast<const bf16*>(a.v) + key0 * DH, 0, C, tid);
  for (int o = 0; o < n_off; ++o) {
    const size_t qrow0 = ((size_t)n * nc + wrap_chunk(jc - o + a.before, nc)) * C;
    load_tile_async<DH, C, kThreads>(qs + o * C * kLd, q + qrow0 * DH, 0, C, tid);
    load_tile_async<DH, C, kThreads>(dos + o * C * kLd, dout + qrow0 * DH, 0, C, tid);
    for (int c = tid; c < C; c += kThreads) {
      qpos_s[o * C + c] = a.pos[qrow0 + c];
      m_s[o * C + c] = a.stats[qrow0 + c];
      il_s[o * C + c] = 1.f / a.stats[rows + qrow0 + c];
      dd_s[o * C + c] = a.stats[2 * rows + qrow0 + c];
    }
  }
  cp_async_commit();
  const int kr = 16 * warp + g;  // this thread's key rows kr and kr + 8
  const int kpos[2] = {a.pos[key0 + kr], a.pos[key0 + kr + 8]};
  const int kval[2] = {a.valid[key0 + kr], a.valid[key0 + kr + 8]};
  cp_async_wait<0>();
  __syncthreads();

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  for (int o = 0; o < n_off; ++o) {
    for (int q0 = 0; q0 < C; q0 += kQB) {
      const bf16* qt = qs + (o * C + q0) * kLd;
      const bf16* dot = dos + (o * C + q0) * kLd;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kQB queries
      float s[kNT][4], dp[kNT][4];
      warp_abt<DH, kQB>(s, ks, 16 * warp, qt, lane);
      warp_abt<DH, kQB>(dp, vs, 16 * warp, dot, lane);
      // P^T (into s) and dS^T (into dp) at each fragment's (key, query)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = o * C + q0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = qpos_s[c];
          const float x = lsh_mask(s[j][e], kval[h], qp, kpos[h], a);
          const float p = exp_fast(x - m_s[c]) * il_s[c];
          dp[j][e] = qp == kpos[h] ? 0.f : p * (dp[j][e] - dd_s[c]);
          s[j][e] = p;
        }
      }
      warp_acc_xb<DH, kQB, true>(dv, s, dot, lane);
      warp_acc_xb<DH, kQB, true>(dk, dp, qt, lane);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_acc_rows<DH>(static_cast<bf16*>(a.dk) + key0 * DH, dk, kr, C, one, lane);
  store_acc_rows<DH>(static_cast<bf16*>(a.dv) + key0 * DH, dv, kr, C, one, lane);
}

template <int DH, int C>
cudaError_t launch_mma(const BwdArgs& a, cudaStream_t stream) {
  const int n_off = a.before + 1 + a.after;
  const size_t smem = mma_smem_bytes<DH, C>(n_off);
  cudaError_t err = cudaFuncSetAttribute(lsh_bwd_dq_mma_kernel<DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lsh_bwd_dkv_mma_kernel<DH, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nc, a.n);
  lsh_bwd_dq_mma_kernel<DH, C><<<grid, 2 * C, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lsh_bwd_dkv_mma_kernel<DH, C><<<grid, 2 * C, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, int C>
cudaError_t mma_resources(int n_off, int* out) {
  const size_t smem = mma_smem_bytes<DH, C>(n_off);
  cudaError_t err = kernel_resources(lsh_bwd_dq_mma_kernel<DH, C>, 2 * C, smem, out);
  if (err != cudaSuccess) return err;
  return kernel_resources(lsh_bwd_dkv_mma_kernel<DH, C>, 2 * C, smem, out + 4);
}

// ---- the f32 path -------------------------------------------------------------

// Rows of one (C, DH) chunk into shared memory with a padded stride.
template <int DH, int C>
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int tid) {
  for (int e = tid; e < C * DH; e += C * kTPR) dst[(e / DH) * (DH + 1) + e % DH] = src[e];
}

// This thread's C / 4 dot products of row r of `rows` with the rows sub + 4 t
// of `cols`, both (C, DH + 1) f32 tiles in shared memory.
template <int DH, int C>
__device__ __forceinline__ void row_dots(const float* rows, const float* cols, int r, int sub,
                                         float (&out)[C / kTPR]) {
#pragma unroll
  for (int t = 0; t < C / kTPR; ++t) out[t] = 0.f;
  for (int d = 0; d < DH; ++d) {
    const float x = rows[r * (DH + 1) + d];
#pragma unroll
    for (int t = 0; t < C / kTPR; ++t) out[t] += x * cols[(sub + kTPR * t) * (DH + 1) + d];
  }
}

template <int DH, int C>
size_t fma_dq_smem_bytes(int n_off) {
  return sizeof(float) * (4 * C * (DH + 1) + (size_t)(n_off + 1) * C * (C + 1)) +
         sizeof(int) * 2 * C;
}

template <int DH, int C>
constexpr size_t fma_dkv_smem_bytes() {
  return sizeof(float) * (4 * C * (DH + 1) + 2 * C * (C + 1) + 3 * C) + sizeof(int) * C;
}

// (a) Block (query chunk i, batch*head n), four threads a query row: three
// passes over the window (scores and the joint max; the joint sum and P;
// dP and D), then dS per offset and dQ in registers.
template <int DH, int C>
__global__ void __launch_bounds__(C * kTPR) lsh_bwd_dq_fma_kernel(BwdArgs a) {
  constexpr int KPT = C / kTPR, CPT = DH / kTPR;
  const int n_off = a.before + 1 + a.after;
  extern __shared__ float smem[];
  float* qs = smem;                        // C x (DH+1), this block's queries
  float* dos = qs + C * (DH + 1);          // C x (DH+1), their dO
  float* ks = dos + C * (DH + 1);          // C x (DH+1), the current key chunk
  float* vs = ks + C * (DH + 1);           // C x (DH+1)
  float* ps = vs + C * (DH + 1);           // n_off x C x (C+1): scores, then P
  float* ds_s = ps + (size_t)n_off * C * (C + 1);  // C x (C+1): dS of one offset
  int* kpos_s = reinterpret_cast<int*>(ds_s + C * (C + 1));
  int* kval_s = kpos_s + C;

  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int n = blockIdx.y, i = blockIdx.x, nc = a.nc;
  const int tid = threadIdx.x, r = tid / kTPR, sub = tid % kTPR;
  const size_t row0 = ((size_t)n * nc + i) * C;

  load_chunk<DH, C>(qs, static_cast<const float*>(a.q) + row0 * DH, tid);
  load_chunk<DH, C>(dos, static_cast<const float*>(a.dout) + row0 * DH, tid);
  const int qpos = a.pos[row0 + r];

  auto load_keys = [&](int o, bool with_k, bool with_v) {
    const size_t key0 = ((size_t)n * nc + wrap_chunk(i + o - a.before, nc)) * C;
    __syncthreads();  // the previous chunk is no longer read
    if (with_k) load_chunk<DH, C>(ks, k + key0 * DH, tid);
    if (with_v) load_chunk<DH, C>(vs, v + key0 * DH, tid);
    if (tid < C) {
      kpos_s[tid] = a.pos[key0 + tid];
      kval_s[tid] = a.valid[key0 + tid];
    }
    __syncthreads();
  };

  // pass 1: masked scores of every offset and the joint row max
  float m = -INFINITY;
  float s[KPT];
  for (int o = 0; o < n_off; ++o) {
    load_keys(o, true, false);
    row_dots<DH, C>(qs, ks, r, sub, s);
    float* po = ps + (size_t)o * C * (C + 1) + r * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int jj = sub + kTPR * t;
      po[jj] = lsh_mask(s[t], kval_s[jj], qpos, kpos_s[jj], a);
      m = fmaxf(m, po[jj]);
    }
  }
  m = quad_max(m);
  // the joint sum, then P (each thread rewrites only its own entries)
  float l = 0.f;
  for (int o = 0; o < n_off; ++o) {
    float* po = ps + (size_t)o * C * (C + 1) + r * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const float e = expf(po[sub + kTPR * t] - m);
      po[sub + kTPR * t] = e;
      l += e;
    }
  }
  l = quad_sum(l);
  const float inv_l = 1.f / l;
  for (int o = 0; o < n_off; ++o) {
    float* po = ps + (size_t)o * C * (C + 1) + r * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) po[sub + kTPR * t] *= inv_l;
  }

  // pass 2: D = rowsum(dP o P)
  float dsum = 0.f;
  float dp[KPT];
  for (int o = 0; o < n_off; ++o) {
    load_keys(o, false, true);
    row_dots<DH, C>(dos, vs, r, sub, dp);
    const float* po = ps + (size_t)o * C * (C + 1) + r * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) dsum += dp[t] * po[sub + kTPR * t];
  }
  const float dd = quad_sum(dsum) - a.dlse[row0 + r];
  if (sub == 0) {
    const size_t rows = (size_t)a.n * nc * C;
    a.stats[row0 + r] = m;
    a.stats[rows + row0 + r] = l;
    a.stats[2 * rows + row0 + r] = dd;
  }

  // pass 3: dS per offset, dQ in registers
  float dq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dq[c] = 0.f;
  for (int o = 0; o < n_off; ++o) {
    load_keys(o, true, true);
    row_dots<DH, C>(dos, vs, r, sub, dp);
    const float* po = ps + (size_t)o * C * (C + 1) + r * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int jj = sub + kTPR * t;
      ds_s[r * (C + 1) + jj] = qpos == kpos_s[jj] ? 0.f : po[jj] * (dp[t] - dd);
    }
    __syncwarp();  // the row's four lanes share their dS entries
    for (int jj = 0; jj < C; ++jj) {
      const float ds = ds_s[r * (C + 1) + jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) dq[c] += ds * ks[jj * (DH + 1) + sub + kTPR * c];
    }
  }
  float* dqb = static_cast<float*>(a.dq) + (row0 + r) * DH;
#pragma unroll
  for (int c = 0; c < CPT; ++c) dqb[sub + kTPR * c] = dq[c];
}

// (b) Block (key chunk j, batch*head n), four threads a key row: per
// offset, P and dS of its key rows against the query chunk that reaches
// it, then dK and dV in registers.
template <int DH, int C>
__global__ void __launch_bounds__(C * kTPR) lsh_bwd_dkv_fma_kernel(BwdArgs a) {
  constexpr int KPT = C / kTPR, CPT = DH / kTPR;
  const int n_off = a.before + 1 + a.after;
  extern __shared__ float smem[];
  float* ks = smem;                        // C x (DH+1), this block's keys
  float* vs = ks + C * (DH + 1);           // C x (DH+1)
  float* qs = vs + C * (DH + 1);           // C x (DH+1), the current query chunk
  float* dos = qs + C * (DH + 1);          // C x (DH+1), its dO
  float* p_s = dos + C * (DH + 1);         // C x (C+1): P^T of one offset
  float* ds_s = p_s + C * (C + 1);         // C x (C+1): dS^T
  float* m_s = ds_s + C * (C + 1);         // C: the query rows' m, 1 / l, D - dlse
  float* il_s = m_s + C;
  float* dd_s = il_s + C;
  int* qpos_s = reinterpret_cast<int*>(dd_s + C);

  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  const int n = blockIdx.y, jc = blockIdx.x, nc = a.nc;
  const int tid = threadIdx.x, r = tid / kTPR, sub = tid % kTPR;
  const size_t key0 = ((size_t)n * nc + jc) * C;
  const size_t rows = (size_t)a.n * nc * C;

  load_chunk<DH, C>(ks, static_cast<const float*>(a.k) + key0 * DH, tid);
  load_chunk<DH, C>(vs, static_cast<const float*>(a.v) + key0 * DH, tid);
  const int kpos = a.pos[key0 + r], kval = a.valid[key0 + r];

  float dk[CPT], dv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dk[c] = dv[c] = 0.f;
  for (int o = 0; o < n_off; ++o) {
    const size_t qrow0 = ((size_t)n * nc + wrap_chunk(jc - o + a.before, nc)) * C;
    __syncthreads();  // the previous query chunk is no longer read
    load_chunk<DH, C>(qs, q + qrow0 * DH, tid);
    load_chunk<DH, C>(dos, dout + qrow0 * DH, tid);
    if (tid < C) {
      qpos_s[tid] = a.pos[qrow0 + tid];
      m_s[tid] = a.stats[qrow0 + tid];
      il_s[tid] = 1.f / a.stats[rows + qrow0 + tid];
      dd_s[tid] = a.stats[2 * rows + qrow0 + tid];
    }
    __syncthreads();
    float s[KPT], dp[KPT];
    row_dots<DH, C>(ks, qs, r, sub, s);
    row_dots<DH, C>(vs, dos, r, sub, dp);
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int qq = sub + kTPR * t, qp = qpos_s[qq];
      const float p = expf(lsh_mask(s[t], kval, qp, kpos, a) - m_s[qq]) * il_s[qq];
      p_s[r * (C + 1) + qq] = p;
      ds_s[r * (C + 1) + qq] = qp == kpos ? 0.f : p * (dp[t] - dd_s[qq]);
    }
    __syncwarp();  // the key row's four lanes share their entries
    for (int qq = 0; qq < C; ++qq) {
      const float p = p_s[r * (C + 1) + qq], ds = ds_s[r * (C + 1) + qq];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = sub + kTPR * c;
        dv[c] += p * dos[qq * (DH + 1) + col];
        dk[c] += ds * qs[qq * (DH + 1) + col];
      }
    }
  }
  float* dkb = static_cast<float*>(a.dk) + (key0 + r) * DH;
  float* dvb = static_cast<float*>(a.dv) + (key0 + r) * DH;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    dkb[sub + kTPR * c] = dk[c];
    dvb[sub + kTPR * c] = dv[c];
  }
}

template <int DH, int C>
cudaError_t launch_fma(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem_dq = fma_dq_smem_bytes<DH, C>(a.before + 1 + a.after);
  constexpr size_t smem_dkv = fma_dkv_smem_bytes<DH, C>();
  cudaError_t err = cudaFuncSetAttribute(lsh_bwd_dq_fma_kernel<DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lsh_bwd_dkv_fma_kernel<DH, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nc, a.n);
  lsh_bwd_dq_fma_kernel<DH, C><<<grid, C * kTPR, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lsh_bwd_dkv_fma_kernel<DH, C><<<grid, C * kTPR, smem_dkv, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mma: 1 = the tensor-core kernels (bf16
// only), 0 = the f32 FMA kernels (f32 only).  q, k, v, dout and dq, dk, dv:
// (n, nc, c, dh), bf16 ones on 16-byte boundaries; pos: (n, nc, c) int32;
// valid: (n, nc, c) bytes; dlse: (n, nc, c) f32; stats: (3, n, nc, c) f32
// scratch (the dQ kernel writes it, the dK/dV kernel reads it).  Returns the
// launches' cudaError_t (0 on success).
extern "C" int rtts_lsh_attend_bwd(const void* q, const void* k, const void* v, const void* pos,
                                   const void* valid, const void* dout, const void* dlse,
                                   void* dq, void* dk, void* dv, void* stats, int mma, int dtype,
                                   int n, int nc, int c, int dh, int causal, int before,
                                   int after, float mask_value, float self_mask_value,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nc == 0) return (int)cudaSuccess;
  if (before < 0 || after < 0 || mma != (dtype == 1)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, static_cast<const int*>(pos), static_cast<const uint8_t*>(valid),
                  dout, static_cast<const float*>(dlse), dq, dk, dv,
                  static_cast<float*>(stats), n, nc, causal, before, after, mask_value,
                  self_mask_value};
#define RTTS_LSH_BWD(LAUNCH, DH, C) \
  if (dh == DH && c == C) return (int)LAUNCH<DH, C>(a, s)
#define RTTS_LSH_BWD_C(LAUNCH, DH) \
  RTTS_LSH_BWD(LAUNCH, DH, 16);    \
  RTTS_LSH_BWD(LAUNCH, DH, 32);    \
  RTTS_LSH_BWD(LAUNCH, DH, 64)
  if (mma) {
    RTTS_LSH_BWD_C(launch_mma, 64);
    RTTS_LSH_BWD_C(launch_mma, 128);
  } else {
    RTTS_LSH_BWD_C(launch_fma, 64);
    RTTS_LSH_BWD_C(launch_fma, 128);
  }
#undef RTTS_LSH_BWD_C
#undef RTTS_LSH_BWD
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernels' resources at (dh, c) and a window of n_off chunks:
// out[0..3] the dQ kernel's, out[4..7] the dK/dV kernel's
// (kernel_resources).  Returns the cudaError_t.
extern "C" int rtts_lsh_attend_bwd_resources(int dh, int c, int n_off, int* out) {
  if (n_off < 1) return (int)cudaErrorInvalidValue;
#define RTTS_LSH_RES(DH, C) \
  if (dh == DH && c == C) return (int)mma_resources<DH, C>(n_off, out)
  RTTS_LSH_RES(64, 16);
  RTTS_LSH_RES(64, 32);
  RTTS_LSH_RES(64, 64);
  RTTS_LSH_RES(128, 16);
  RTTS_LSH_RES(128, 32);
  RTTS_LSH_RES(128, 64);
#undef RTTS_LSH_RES
  return (int)cudaErrorInvalidValue;
}
