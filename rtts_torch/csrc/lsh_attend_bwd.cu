// LSH chunk-attend backward for Hopper, sm_90a: kernel K5.
//
// Replaces the TPU kernel rtts/ops/lsh_attention.py::_attend_bwd_kernel
// (launched by _attend_bwd_pallas_raw from the custom_vjp's _bwd_rule).
// Given K4's inputs (lsh_attend_fwd.cu) and the cotangents dO of the output
// and dlse of the logsumexp, it recomputes the joint softmax of each query
// chunk over its window and forms
//
//   P   = softmax(s_masked)                 over all window offsets at once
//   dP  = dO V^T,   D = rowsum(dP o P)
//   dS  = P o (dP - D) + P o dlse,   0 on the self entries (q_pos == k_pos:
//         the score there is a replaced constant, so it has no derivative)
//   dQ  = dS K,   dK = dS^T Q,   dV = P^T dO   (dV keeps the self entries)
//
// The dlse term is needed: the multi-round combine weights each round by
// exp(lse - logsumexp(lse)), so gradients reach lse.  The softmax is
// recomputed exactly (max and sum of the scores), not as exp(s - lse), so a
// row left with only its self entries at -1e5 keeps exact probabilities.
//
// Design (deterministic, no atomics).  One block per (batch*head, query
// chunk i), 4 threads per query row, as the TPU splits the work.  It keeps
// its c queries and dO rows and the probabilities of all its window offsets
// in shared memory, streams the neighbour key/value chunks (i + off) mod nc
// by index, and makes three passes: scores and the joint max and sum; dP and
// D; then dS, with dQ accumulated in registers and, per offset, the block's
// dK and dV contribution to key chunk (i + off) mod nc written as f32 to
// slab [offset] at that chunk.  Each slab entry has exactly one writer; the
// wrapper sums the slabs over the offsets in a fixed order, so two runs give
// bit-equal gradients.
//
// What bounds it on this card: at the longform decoder shape (n 16, nc 512,
// c 64, dh 64, bf16) the gradients need ~0.48 GB of HBM traffic (0.14 ms)
// and 43 GFLOP; this kernel does 6 products instead of 5 (dP twice) as f32
// FMAs through shared memory, at least ~0.77 ms at 67 TFLOP/s, plus 0.54 GB
// of f32 slabs written and summed: FMA- and shared-memory-bound.  Tensor
// cores, TMA and an in-kernel combine of the slabs are later work.

#include "flash_common.cuh"

namespace {

constexpr int kTPR = 4;           // threads per query row (and per key row)

struct BwdArgs {
  const void *q, *k, *v;
  const int* pos;
  const uint8_t* valid;
  const void* dout;
  const float* dlse;
  void* dq;
  float *dk_off, *dv_off;
  int n, nc, causal, before, after;
  float mask_value, self_mask_value;
};

template <int DH, int C>
size_t bwd_smem_bytes(int n_off) {
  return sizeof(float) * (4 * C * (DH + 1) + (size_t)(n_off + 1) * C * (C + 1)) +
         sizeof(int) * 2 * C;
}

// Rows of one (C, DH) chunk into shared memory as f32 with a padded stride.
template <typename T, int DH, int C>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int tid) {
  for (int e = tid; e < C * DH; e += C * kTPR) dst[(e / DH) * (DH + 1) + e % DH] = to_f32(src[e]);
}

template <typename T, int DH, int C>
__global__ void __launch_bounds__(C * kTPR) lsh_attend_bwd_kernel(BwdArgs a) {
  constexpr int KPT = C / kTPR;     // keys per thread per chunk (score phases)
  constexpr int CPT = DH / kTPR;    // columns per thread (accumulation phases)
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

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int n = blockIdx.y, i = blockIdx.x, nc = a.nc;
  const int tid = threadIdx.x, r = tid / kTPR, sub = tid % kTPR;
  const size_t row0 = ((size_t)n * nc + i) * C;

  load_chunk<T, DH, C>(qs, q + row0 * DH, tid);
  load_chunk<T, DH, C>(dos, dout + row0 * DH, tid);
  const int qpos = a.pos[row0 + r];
  const float dlse = a.dlse[row0 + r];

  auto key_chunk = [&](int o) { return ((i + o - a.before) % nc + nc) % nc; };
  auto load_keys = [&](int o, bool with_k, bool with_v) {
    const size_t key0 = ((size_t)n * nc + key_chunk(o)) * C;
    __syncthreads();  // the previous chunk is no longer read
    if (with_k) load_chunk<T, DH, C>(ks, k + key0 * DH, tid);
    if (with_v) load_chunk<T, DH, C>(vs, v + key0 * DH, tid);
    if (tid < C) {
      kpos_s[tid] = a.pos[key0 + tid];
      kval_s[tid] = a.valid[key0 + tid];
    }
    __syncthreads();
  };
  // this thread's KPT dot products of row r (of qs or dos) with the chunk
  // rows sub + 4t of ks or vs
  auto row_dots = [&](const float* rows, const float* keys, float* out) {
#pragma unroll
    for (int t = 0; t < KPT; ++t) out[t] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float x = rows[r * (DH + 1) + d];
#pragma unroll
      for (int t = 0; t < KPT; ++t) out[t] += x * keys[(sub + kTPR * t) * (DH + 1) + d];
    }
  };

  // pass 1: masked scores of every offset and the joint row max
  float m = -INFINITY;
  float s[KPT];
  for (int o = 0; o < n_off; ++o) {
    load_keys(o, true, false);
    row_dots(qs, ks, s);
    float* po = ps + (size_t)o * C * (C + 1) + r * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int jj = sub + kTPR * t;
      const int kp = kpos_s[jj];
      float x = s[t];
      if (!kval_s[jj]) x = a.mask_value;
      if (a.causal && qpos < kp) x = a.mask_value;
      if (qpos == kp) x = a.self_mask_value;
      po[jj] = x;
      m = fmaxf(m, x);
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
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
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
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
    row_dots(dos, vs, dp);
    const float* po = ps + (size_t)o * C * (C + 1) + r * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) dsum += dp[t] * po[sub + kTPR * t];
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);

  // pass 3: dS per offset; dQ in registers; dK, dV of the key chunk to its slab
  float dq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dq[c] = 0.f;
  const int jrow = tid / kTPR;   // key row owned in the dK/dV phase
  for (int o = 0; o < n_off; ++o) {
    load_keys(o, true, true);
    row_dots(dos, vs, dp);
    const float* po = ps + (size_t)o * C * (C + 1);
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int jj = sub + kTPR * t;
      const float p = po[r * (C + 1) + jj];
      float ds = p * (dp[t] - dsum) + p * dlse;
      if (qpos == kpos_s[jj]) ds = 0.f;
      ds_s[r * (C + 1) + jj] = ds;
    }
    __syncthreads();  // every row's dS of this offset is in ds_s
    for (int jj = 0; jj < C; ++jj) {
      const float ds = ds_s[r * (C + 1) + jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) dq[c] += ds * ks[jj * (DH + 1) + sub + kTPR * c];
    }
    float dk[CPT], dv[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[c] = dv[c] = 0.f;
    for (int rr = 0; rr < C; ++rr) {
      const float ds = ds_s[rr * (C + 1) + jrow];
      const float p = po[rr * (C + 1) + jrow];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = sub + kTPR * c;
        dk[c] += ds * qs[rr * (DH + 1) + col];
        dv[c] += p * dos[rr * (DH + 1) + col];
      }
    }
    const size_t slab = (((size_t)o * a.n + n) * nc + key_chunk(o)) * C + jrow;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      a.dk_off[slab * DH + sub + kTPR * c] = dk[c];
      a.dv_off[slab * DH + sub + kTPR * c] = dv[c];
    }
  }
  T* dqb = static_cast<T*>(a.dq) + (row0 + r) * DH;
#pragma unroll
  for (int c = 0; c < CPT; ++c) dqb[sub + kTPR * c] = from_f32<T>(dq[c]);
}

template <typename T, int DH, int C>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<DH, C>(a.before + 1 + a.after);
  cudaError_t err = cudaFuncSetAttribute(lsh_attend_bwd_kernel<T, DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nc, a.n);
  lsh_attend_bwd_kernel<T, DH, C><<<grid, C * kTPR, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq: (n, nc, c, dh); pos:
// (n, nc, c) int32; valid: (n, nc, c) bytes; dlse: (n, nc, c) f32; dk_off,
// dv_off: (before + 1 + after, n, nc, c, dh) f32, slab o holding the
// contribution of window offset o - before, at the key chunk it reached.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rtts_lsh_attend_bwd(const void* q, const void* k, const void* v, const void* pos,
                                   const void* valid, const void* dout, const void* dlse,
                                   void* dq, void* dk_off, void* dv_off, int dtype, int n, int nc,
                                   int c, int dh, int causal, int before, int after,
                                   float mask_value, float self_mask_value, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nc == 0) return (int)cudaSuccess;
  const BwdArgs a{q, k, v, static_cast<const int*>(pos), static_cast<const uint8_t*>(valid),
                  dout, static_cast<const float*>(dlse), dq, static_cast<float*>(dk_off),
                  static_cast<float*>(dv_off), n, nc, causal, before, after, mask_value,
                  self_mask_value};
#define RTTS_LSH_BWD(T, DH, C) \
  if (dh == DH && c == C) return (int)launch_bwd<T, DH, C>(a, s)
#define RTTS_LSH_BWD_C(T, DH) \
  RTTS_LSH_BWD(T, DH, 16);    \
  RTTS_LSH_BWD(T, DH, 32);    \
  RTTS_LSH_BWD(T, DH, 64)
  if (dtype == 0) {
    RTTS_LSH_BWD_C(float, 64);
    RTTS_LSH_BWD_C(float, 128);
  } else if (dtype == 1) {
    RTTS_LSH_BWD_C(__nv_bfloat16, 64);
    RTTS_LSH_BWD_C(__nv_bfloat16, 128);
  }
#undef RTTS_LSH_BWD_C
#undef RTTS_LSH_BWD
  return (int)cudaErrorInvalidValue;
}
