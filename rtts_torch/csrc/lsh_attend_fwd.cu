// LSH chunk-attend forward for Hopper, sm_90a: kernel K4.
//
// Replaces the TPU kernel rtts/ops/lsh_attention.py::_attend_kernel (launched
// by _attend_pallas_raw through lsh_attend_chunks_pallas).  Inputs are the
// bucket-sorted rows cut into chunks: q, k, v (n = batch*heads, nc, c, dh)
// with k already length-normalised and scaled, and per sorted slot its
// original position pos and key validity valid (n, nc, c).  Chunk i of
// queries attends the key chunks (i + off) mod nc for off in [-before, after]
// with ONE joint softmax:
//
//   s = q . k                                   f32
//   s := mask_value       where the key is invalid (padding)
//   s := mask_value       where causal and q_pos < k_pos
//   s := self_mask_value  where q_pos == k_pos (even on an invalid key)
//   out = softmax(s) @ v,   lse = m + log(l)    (f32)
//
// Masks replace scores, in that order, by ORIGINAL positions.  The chunk
// index wraps over the whole nc axis (all hash rounds together), so a
// position can sit twice in one window; both entries count, as in the
// reference.  Every row holds its own position, so l > 0.
//
// Design.  One block per (batch*head, query chunk), 4 threads per query row
// (4c threads).  The block keeps its c queries in shared memory as f32 and
// loads each neighbour key/value chunk straight from its index: no rolled
// copies of k/v are made (the TPU wrapper's _roll_chunks), and there is no
// blocking of 8 chunks (the TPU's _CB, a tiling constraint).  The running
// max, sum and output (dh/4 columns per thread) live in registers; the
// row's four lanes reduce with warp shuffles, as in flash_fwd.cu.
//
// What bounds it on this card: at the longform decoder shape (n 16, nc 512,
// c 64, dh 64, bf16) the call moves ~0.28 GB (0.082 ms of HBM at 3.35 TB/s)
// and does 17 GFLOP, which as f32 FMAs through shared memory take at least
// 0.26 ms at 67 TFLOP/s: the FMA pipe and shared-memory bandwidth bound it.
// Tensor-core tiles (mma / wgmma) and TMA are later work.

#include "flash_common.cuh"

namespace {

constexpr int kTPR = 4;           // threads per query row
constexpr float kNegInit = -1e30f;

template <int DH, int C>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (2 * C * (DH + 1) + C * DH + C * (C + 1)) + sizeof(int) * 2 * C;
}

template <typename T, int DH, int C>
__global__ void __launch_bounds__(C * kTPR)
lsh_attend_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ pos, const uint8_t* __restrict__ valid,
                      T* __restrict__ out, float* __restrict__ lse, int nc, int causal,
                      int before, int after, float mask_value, float self_mask_value) {
  constexpr int kThreads = C * kTPR;
  constexpr int KPT = C / kTPR;     // keys per thread per chunk
  constexpr int CPT = DH / kTPR;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // C x (DH+1)
  float* ks = qs + C * (DH + 1);             // C x (DH+1)
  float* vs = ks + C * (DH + 1);             // C x DH
  float* ps = vs + C * DH;                   // C x (C+1)
  int* kpos_s = reinterpret_cast<int*>(ps + C * (C + 1));  // C
  int* kval_s = kpos_s + C;                                // C

  const int n = blockIdx.y;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int sub = tid % kTPR;
  const size_t row0 = ((size_t)n * nc + i) * C;   // first row of the query chunk

  for (int e = tid; e < C * DH; e += kThreads) {
    const int rr = e / DH, c = e % DH;
    qs[rr * (DH + 1) + c] = to_f32(q[row0 * DH + e]);
  }
  const int qpos = pos[row0 + r];

  float m = kNegInit, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  for (int off = -before; off <= after; ++off) {
    const int j = ((i + off) % nc + nc) % nc;
    const size_t key0 = ((size_t)n * nc + j) * C;
    __syncthreads();  // the previous chunk's K/V/P are no longer read
    for (int e = tid; e < C * DH; e += kThreads) {
      const int jj = e / DH, c = e % DH;
      ks[jj * (DH + 1) + c] = to_f32(k[key0 * DH + e]);
      vs[jj * DH + c] = to_f32(v[key0 * DH + e]);
    }
    if (tid < C) {
      kpos_s[tid] = pos[key0 + tid];
      kval_s[tid] = valid[key0 + tid];
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int t = 0; t < KPT; ++t) s[t] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = qs[r * (DH + 1) + d];
#pragma unroll
      for (int t = 0; t < KPT; ++t) s[t] += qd * ks[(sub + kTPR * t) * (DH + 1) + d];
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int jj = sub + kTPR * t;
      const int kp = kpos_s[jj];
      if (!kval_s[jj]) s[t] = mask_value;
      if (causal && qpos < kp) s[t] = mask_value;
      if (qpos == kp) s[t] = self_mask_value;
      tmax = fmaxf(tmax, s[t]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const float p = expf(s[t] - m_new);
      psum += p;
      ps[r * (C + 1) + sub + kTPR * t] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four lanes share their P entries

#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
    for (int jj = 0; jj < C; ++jj) {
      const float p = ps[r * (C + 1) + jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += p * vs[jj * DH + sub + kTPR * c];
    }
  }

  const float inv = l == 0.f ? 1.f : 1.f / l;
  T* ob = out + (row0 + r) * DH;
#pragma unroll
  for (int c = 0; c < CPT; ++c) ob[sub + kTPR * c] = from_f32<T>(acc[c] * inv);
  if (sub == 0) lse[row0 + r] = m + logf(l == 0.f ? 1.f : l);
}

template <typename T, int DH, int C>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* pos,
                       const void* valid, void* out, void* lse, int n, int nc, int causal,
                       int before, int after, float mask_value, float self_mask_value,
                       cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DH, C>();
  cudaError_t err = cudaFuncSetAttribute(lsh_attend_fwd_kernel<T, DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nc, n);
  lsh_attend_fwd_kernel<T, DH, C><<<grid, C * kTPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<const uint8_t*>(valid), static_cast<T*>(out),
      static_cast<float*>(lse), nc, causal, before, after, mask_value, self_mask_value);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, out: (n, nc, c, dh); pos: (n,
// nc, c) int32 original positions; valid: (n, nc, c) bytes; lse: (n, nc, c)
// f32.  c in {16, 32, 64}, dh in {64, 128}.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int rtts_lsh_attend_fwd(const void* q, const void* k, const void* v, const void* pos,
                                   const void* valid, void* out, void* lse, int dtype, int n,
                                   int nc, int c, int dh, int causal, int before, int after,
                                   float mask_value, float self_mask_value, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nc == 0) return (int)cudaSuccess;
#define RTTS_LSH_FWD(T, DH, C)                                                                 \
  if (dh == DH && c == C)                                                                      \
  return (int)launch_fwd<T, DH, C>(q, k, v, pos, valid, out, lse, n, nc, causal, before, after, \
                                   mask_value, self_mask_value, s)
#define RTTS_LSH_FWD_C(T, DH) \
  RTTS_LSH_FWD(T, DH, 16);    \
  RTTS_LSH_FWD(T, DH, 32);    \
  RTTS_LSH_FWD(T, DH, 64)
  if (dtype == 0) {
    RTTS_LSH_FWD_C(float, 64);
    RTTS_LSH_FWD_C(float, 128);
  } else if (dtype == 1) {
    RTTS_LSH_FWD_C(__nv_bfloat16, 64);
    RTTS_LSH_FWD_C(__nv_bfloat16, 128);
  }
#undef RTTS_LSH_FWD_C
#undef RTTS_LSH_FWD
  return (int)cudaErrorInvalidValue;
}
