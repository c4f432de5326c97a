// Flash-attention backward (FA2) for Hopper, sm_90a: kernel K3.
//
// Replaces the TPU kernels rtts/ops/flash_attention.py::_dkv_kernel and
// ::_dq_kernel (launched by _bwd_impl).  Given the forward's inputs, its
// output o, the f32 row statistic lse = m + log(l) and the upstream dO, each
// probability tile is recomputed, never stored:
//
//   P   = exp(s_masked - lse)               s_masked as in flash_fwd.cu
//   R   = keep / keep_prob                  the forward's dropout (1 if off)
//   dV  = (P o R)^T dO
//   dP  = dO V^T,   Di = rowsum(o o dO)
//   dS  = P o (R o dP - Di),  0 on the self diagonal,  then * sm_scale
//   dK  = dS^T Q,   dQ = dS K
//
// Pad and causal positions need no explicit zero: their P is exp(-1e9 -
// lse) = 0.  The self diagonal's score is a replaced constant, so its dS is
// zeroed (_self_zero).  Keys past the end of the sequence have P = 0; query
// rows past the end are left out (P = 0) and nothing past either end is
// written.  Causal tiles wholly above the diagonal are skipped as on the TPU.
//
// Two kernels, as on the TPU, because blocks cannot carry sums between them:
// rtts_flash_bwd_dkv runs one block per (batch*head, 64-key tile) that
// loops over the query tiles and owns its dK/dV rows; rtts_flash_bwd_dq runs
// one block per (batch*head, 64-query tile) that loops over the key tiles
// and owns its dQ rows.  Both compute Di from the o and dO tiles they load.
//
// What bounds it on this card: at the training shapes (B*H = 64, L 256 to
// 1024, dh 64) the work is 5 (dK/dV kernel) and 3 (dQ kernel) L x L x dh
// products per batch*head, done here as f32 FMAs through shared memory:
// the FMA pipe and shared-memory bandwidth bound it, not HBM.  Design as in
// flash_fwd.cu: 256 threads, four per tile row; the score phase gives each
// thread 16 (query, key) entries, the accumulation phase dh/4 columns of
// one key row (dK, dV) or query row (dQ), accumulated in f32 registers.
// Tensor-core tiles (mma / wgmma) and TMA are later work.

#include "flash_common.cuh"

namespace {

constexpr int kB = 64;         // rows of a query tile and of a key tile
constexpr int kTPR = 4;        // threads per tile row
constexpr int kThreads = kB * kTPR;
constexpr int kKPT = kB / kTPR;  // (query, key) entries per thread per tile

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const uint8_t* kv_mask;
  void *dq, *dk, *dv;
  int heads, lq, lk;
  float sm_scale;
  int causal, self_mask, q_offset;
  uint32_t seed;
  int drop_thr;
  float drop_scale;
};

// Rows [r0, r0 + kB) of a (rows, DH) tensor into shared memory as f32 with a
// padded stride; rows past n read as 0.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int n, int tid) {
  for (int i = tid; i < kB * DH; i += kThreads) {
    const int rr = i / DH, c = i % DH, g = r0 + rr;
    dst[rr * (DH + 1) + c] = g < n ? to_f32(src[(size_t)g * DH + c]) : 0.f;
  }
}

// Di = rowsum(o o dO) and lse of the query tile at q0 (0 past the end).
template <typename T, int DH>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* di_s, const float* lse_b,
                                               const T* ob, const float* dos, int q0, int lq,
                                               int tid) {
  // four lanes per row, each summing dh/4 columns
  const int r = tid / kTPR, sub = tid % kTPR, gq = q0 + r;
  float acc = 0.f;
  if (gq < lq) {
    for (int c = sub; c < DH; c += kTPR)
      acc += to_f32(ob[(size_t)gq * DH + c]) * dos[r * (DH + 1) + c];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (sub == 0) {
    di_s[r] = acc;
    lse_s[r] = gq < lq ? lse_b[gq] : 0.f;
  }
}

// Key-tile validity: 1 valid, 0 pad, -1 past the end.
__device__ __forceinline__ void load_key_mask(int* ms, const uint8_t* kv_mask, int b, int k0,
                                              int lk, int tid) {
  if (tid < kB) {
    const int gk = k0 + tid;
    ms[tid] = gk >= lk ? -1 : (kv_mask == nullptr ? 1 : (kv_mask[(size_t)b * lk + gk] != 0));
  }
}

// The score phase of one (query tile, key tile) pair.  Thread (r, sub) owns
// query row r and keys j = sub + 4 i.  Writes dS (already * sm_scale) to
// ds_s and, when pr_s is given, P o R to pr_s, both kB x (kB + 1).
template <int DH>
__device__ __forceinline__ void score_grads(const float* qs, const float* ks, const float* vs,
                                            const float* dos, const float* lse_s,
                                            const float* di_s, const int* ms, float* ds_s,
                                            float* pr_s, int q0, int k0, int lq, int bh,
                                            const BwdArgs& a, int tid) {
  const int r = tid / kTPR, sub = tid % kTPR;
  const int qpos = a.q_offset + q0 + r;
  const bool row_in = q0 + r < lq;
  float s[kKPT], dp[kKPT];
#pragma unroll
  for (int i = 0; i < kKPT; ++i) s[i] = dp[i] = 0.f;
  for (int d = 0; d < DH; ++d) {
    const float qd = qs[r * (DH + 1) + d];
    const float dod = dos[r * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < kKPT; ++i) {
      const int j = sub + kTPR * i;
      s[i] += qd * ks[j * (DH + 1) + d];
      dp[i] += dod * vs[j * (DH + 1) + d];
    }
  }
  const float row_lse = lse_s[r], di = di_s[r];
#pragma unroll
  for (int i = 0; i < kKPT; ++i) {
    const int j = sub + kTPR * i, gk = k0 + j;
    const float x = mask_score(s[i] * a.sm_scale, ms[j], qpos, gk, a.causal, a.self_mask);
    const float p = row_in ? expf(x - row_lse) : 0.f;
    const float rs = a.drop_thr > 0
                         ? drop_rscale(a.seed, bh, qpos, gk, a.drop_thr, a.drop_scale)
                         : 1.f;
    float ds = p * (rs * dp[i] - di);
    if (a.self_mask && qpos == gk) ds = 0.f;
    ds_s[r * (kB + 1) + j] = ds * a.sm_scale;
    if (pr_s != nullptr) pr_s[r * (kB + 1) + j] = p * rs;
  }
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kB * (DH + 1) + 2 * kB * (kB + 1) + 2 * kB) + sizeof(int) * kB;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int CPT = DH / kTPR;
  extern __shared__ float smem[];
  float* ks = smem;                        // kB x (DH+1), this block's keys
  float* vs = ks + kB * (DH + 1);          // kB x (DH+1)
  float* qs = vs + kB * (DH + 1);          // kB x (DH+1), the current query tile
  float* dos = qs + kB * (DH + 1);         // kB x (DH+1)
  float* pr_s = dos + kB * (DH + 1);       // kB x (kB+1): P o R
  float* ds_s = pr_s + kB * (kB + 1);      // kB x (kB+1): dS
  float* lse_s = ds_s + kB * (kB + 1);     // kB
  float* di_s = lse_s + kB;                // kB
  int* ms = reinterpret_cast<int*>(di_s + kB);

  const int bh = blockIdx.y, b = bh / a.heads;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x;
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.lq * DH;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.lk * DH;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.lk * DH;
  const T* ob = static_cast<const T*>(a.o) + (size_t)bh * a.lq * DH;
  const T* dob = static_cast<const T*>(a.dout) + (size_t)bh * a.lq * DH;
  const float* lse_b = a.lse + (size_t)bh * a.lq;

  load_tile<T, DH>(ks, kb, k0, a.lk, tid);
  load_tile<T, DH>(vs, vb, k0, a.lk, tid);
  load_key_mask(ms, a.kv_mask, b, k0, a.lk, tid);

  // accumulation phase: thread (j, sub) owns key row j, columns sub + 4 c
  const int j = tid / kTPR, sub = tid % kTPR;
  float dk[CPT], dv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < a.lq; q0 += kB) {
    if (a.causal && a.q_offset + q0 + kB - 1 < k0) continue;  // tile above the diagonal
    __syncthreads();  // the previous tile's Q/dO/P/dS are no longer read
    load_tile<T, DH>(qs, qb, q0, a.lq, tid);
    load_tile<T, DH>(dos, dob, q0, a.lq, tid);
    __syncthreads();
    load_row_stats<T, DH>(lse_s, di_s, lse_b, ob, dos, q0, a.lq, tid);
    __syncthreads();
    score_grads<DH>(qs, ks, vs, dos, lse_s, di_s, ms, ds_s, pr_s, q0, k0, a.lq, bh, a, tid);
    __syncthreads();
    for (int i = 0; i < kB; ++i) {
      const float pr = pr_s[i * (kB + 1) + j], ds = ds_s[i * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = sub + kTPR * c;
        dv[c] += pr * dos[i * (DH + 1) + col];
        dk[c] += ds * qs[i * (DH + 1) + col];
      }
    }
  }

  const int gk = k0 + j;
  if (gk < a.lk) {
    T* dkb = static_cast<T*>(a.dk) + ((size_t)bh * a.lk + gk) * DH;
    T* dvb = static_cast<T*>(a.dv) + ((size_t)bh * a.lk + gk) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkb[sub + kTPR * c] = from_f32<T>(dk[c]);
      dvb[sub + kTPR * c] = from_f32<T>(dv[c]);
    }
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (DH + 1) + kB * (kB + 1) + 2 * kB) + sizeof(int) * kB;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int CPT = DH / kTPR;
  extern __shared__ float smem[];
  float* qs = smem;                        // kB x (DH+1), this block's queries
  float* dos = qs + kB * (DH + 1);         // kB x (DH+1)
  float* ks = dos + kB * (DH + 1);         // kB x (DH+1), the current key tile
  float* vs = ks + kB * (DH + 1);          // kB x (DH+1)
  float* ds_s = vs + kB * (DH + 1);        // kB x (kB+1): dS
  float* lse_s = ds_s + kB * (kB + 1);     // kB
  float* di_s = lse_s + kB;                // kB
  int* ms = reinterpret_cast<int*>(di_s + kB);

  const int bh = blockIdx.y, b = bh / a.heads;
  const int q0 = blockIdx.x * kB;
  const int tid = threadIdx.x;
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.lq * DH;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.lk * DH;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.lk * DH;
  const T* ob = static_cast<const T*>(a.o) + (size_t)bh * a.lq * DH;
  const T* dob = static_cast<const T*>(a.dout) + (size_t)bh * a.lq * DH;

  load_tile<T, DH>(qs, qb, q0, a.lq, tid);
  load_tile<T, DH>(dos, dob, q0, a.lq, tid);
  __syncthreads();
  load_row_stats<T, DH>(lse_s, di_s, a.lse + (size_t)bh * a.lq, ob, dos, q0, a.lq, tid);

  // accumulation phase: thread (r, sub) owns query row r, columns sub + 4 c
  const int r = tid / kTPR, sub = tid % kTPR;
  float dq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dq[c] = 0.f;

  for (int k0 = 0; k0 < a.lk; k0 += kB) {
    if (a.causal && a.q_offset + q0 + kB - 1 < k0) break;  // the rest is above the diagonal
    __syncthreads();  // the previous tile's K/V/dS are no longer read
    load_tile<T, DH>(ks, kb, k0, a.lk, tid);
    load_tile<T, DH>(vs, vb, k0, a.lk, tid);
    load_key_mask(ms, a.kv_mask, b, k0, a.lk, tid);
    __syncthreads();
    score_grads<DH>(qs, ks, vs, dos, lse_s, di_s, ms, ds_s, nullptr, q0, k0, a.lq, bh, a, tid);
    __syncwarp();  // the row's four lanes share their dS entries
    for (int jj = 0; jj < kB; ++jj) {
      const float ds = ds_s[r * (kB + 1) + jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) dq[c] += ds * ks[jj * (DH + 1) + sub + kTPR * c];
    }
  }

  const int gq = q0 + r;
  if (gq < a.lq) {
    T* dqb = static_cast<T*>(a.dq) + ((size_t)bh * a.lq + gq) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqb[sub + kTPR * c] = from_f32<T>(dq[c]);
  }
}

template <typename T, int DH>
cudaError_t launch_dkv(const BwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lk + kB - 1) / kB, bh);
  flash_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dq(const BwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + kB - 1) / kB, bh);
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, const void* kv_mask, void* dq, void* dk, void* dv, int heads,
                  int lq, int lk, float sm_scale, int causal, int self_mask, int q_offset,
                  unsigned int seed, int drop_thr, float drop_scale) {
  return BwdArgs{q, k, v, o, dout, static_cast<const float*>(lse),
                 static_cast<const uint8_t*>(kv_mask), dq, dk, dv, heads, lq, lk, sm_scale,
                 causal, self_mask, q_offset, seed, drop_thr, drop_scale};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout: (bh, lq, dh); k, v: (bh,
// lk, dh); lse: (bh, lq) f32 from the forward; kv_mask: (bh / heads, lk)
// bytes or null; seed / drop_thr / drop_scale as in rtts_flash_fwd.  The
// dK/dV kernel writes dk, dv (like k, v); the dQ kernel writes dq (like q).
// Each returns the launch's cudaError_t (0 on success).
#define RTTS_BWD_INPUTS                                                                      \
  const void *q, const void *k, const void *v, const void *o, const void *dout,              \
      const void *lse, const void *kv_mask
#define RTTS_BWD_SCALARS                                                                     \
  int dtype, int bh, int heads, int lq, int lk, int dh, float sm_scale, int causal,          \
      int self_mask, int q_offset, unsigned int seed, int drop_thr, float drop_scale,        \
      void *stream
#define RTTS_BWD_DISPATCH(LAUNCH)                                                            \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                                       \
  if (dtype == 0 && dh == 64) return (int)LAUNCH<float, 64>(a, bh, s);                       \
  if (dtype == 0 && dh == 128) return (int)LAUNCH<float, 128>(a, bh, s);                     \
  if (dtype == 1 && dh == 64) return (int)LAUNCH<__nv_bfloat16, 64>(a, bh, s);               \
  if (dtype == 1 && dh == 128) return (int)LAUNCH<__nv_bfloat16, 128>(a, bh, s);             \
  return (int)cudaErrorInvalidValue

extern "C" int rtts_flash_bwd_dkv(RTTS_BWD_INPUTS, void* dk, void* dv, RTTS_BWD_SCALARS) {
  if (bh == 0 || lk == 0) return (int)cudaSuccess;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, kv_mask, nullptr, dk, dv, heads, lq, lk,
                              sm_scale, causal, self_mask, q_offset, seed, drop_thr, drop_scale);
  RTTS_BWD_DISPATCH(launch_dkv);
}

extern "C" int rtts_flash_bwd_dq(RTTS_BWD_INPUTS, void* dq, RTTS_BWD_SCALARS) {
  if (bh == 0 || lq == 0) return (int)cudaSuccess;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, kv_mask, dq, nullptr, nullptr, heads, lq,
                              lk, sm_scale, causal, self_mask, q_offset, seed, drop_thr,
                              drop_scale);
  RTTS_BWD_DISPATCH(launch_dq);
}
