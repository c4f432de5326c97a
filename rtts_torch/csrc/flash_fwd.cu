// Flash-attention forward (online softmax) for Hopper, sm_90a.
//
// Replaces the TPU kernel rtts/ops/flash_attention.py::_fwd_kernel (with its
// launcher _fwd_impl and the flash_attend wrapper).  Same contract:
//
//   s = (q . k) * sm_scale                       f32 scores
//   s := -1e9  (kMaskValue)      where the key is padding (kv_mask == 0)
//   s := -1e9  (kMaskValue)      where causal and q_offset + row < col
//   s := -1e5  (kSelfMaskValue)  where self_mask and q_offset + row == col
//   o = dropout(softmax(s)) @ v,   lse = m + log(l)   (optional, f32)
//
// Masks REPLACE scores (they are not added), in that order, so a query whose
// keys are all masked still attends itself through the milder self value.
// The running max starts at the finite -1e30 and l == 0 is guarded, as in
// the TPU kernel.  Keys past the end of the sequence (the ragged last tile)
// are left out of the softmax altogether, which is what the plain version
// (rtts_torch/ops/flash_attention.py::flash_attend_reference) computes; the
// TPU wrapper's pad-to-128 copy is not needed.
//
// Attention-probs dropout (drop_thr > 0) is the TPU kernel's counter hash,
// bit for bit (flash_common.cuh::keep): the keep bit of (bh, global row,
// global col) is regenerated here and in both backward kernels
// (flash_bwd.cu), so no mask is stored.  It applies to P.V only: m, l and
// lse are those of the undropped softmax.
//
// What bounds it on this card: at the serving shapes (B*H = 64, L = 256,
// dh = 64) the whole call is ~1 GFLOP over ~8 MB, far too small to be
// bound by HBM or the tensor cores; the time is the f32 FMA work through
// shared memory and the launch.  Design: one 256-thread block per
// (batch*head, 64-row query tile); K/V tiles of 64 rows are staged in
// shared memory as f32, four threads own one query row (16 keys of each
// tile for the scores, dh/4 output columns for P.V), and the row max and
// sum are reduced across those four lanes with warp shuffles.  No L x L
// tensor is written.  Tensor-core tiles (mma / wgmma) are later work.

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kTPR = 4;        // threads per query row
constexpr int kThreads = kBQ * kTPR;
constexpr float kNegInit = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1)) +
         sizeof(int) * kBK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, T* __restrict__ out,
                 float* __restrict__ lse, int heads, int lq, int lk, float sm_scale,
                 int causal, int self_mask, int q_offset, uint32_t seed, int drop_thr,
                 float drop_scale) {
  constexpr int KPT = kBK / kTPR;   // scores per thread per tile
  constexpr int CPT = DH / kTPR;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // kBQ x (DH+1)
  float* ks = qs + kBQ * (DH + 1);           // kBK x (DH+1)
  float* vs = ks + kBK * (DH + 1);           // kBK x DH
  float* ps = vs + kBK * DH;                 // kBQ x (kBK+1)
  int* ms = reinterpret_cast<int*>(ps + kBQ * (kBK + 1));  // kBK: 1 valid, 0 pad, -1 past end

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int sub = tid % kTPR;
  const T* qb = q + (size_t)bh * lq * DH;
  const T* kb = k + (size_t)bh * lk * DH;
  const T* vb = v + (size_t)bh * lk * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int rr = i / DH, c = i % DH, gq = q0 + rr;
    qs[rr * (DH + 1) + c] = gq < lq ? to_f32(qb[(size_t)gq * DH + c]) : 0.f;
  }

  const int qpos = q_offset + q0 + r;
  float m = kNegInit, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kBK) {
    // causal: key tiles wholly after the block's last row are skipped, as
    // the TPU kernel's pl.when does (the test is uniform over the block)
    if (causal && q_offset + q0 + kBQ - 1 < k0) break;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int j = i / DH, c = i % DH, gk = k0 + j;
      const bool in = gk < lk;
      ks[j * (DH + 1) + c] = in ? to_f32(kb[(size_t)gk * DH + c]) : 0.f;
      vs[j * DH + c] = in ? to_f32(vb[(size_t)gk * DH + c]) : 0.f;
    }
    if (tid < kBK) {
      const int gk = k0 + tid;
      ms[tid] = gk >= lk ? -1 : (kv_mask == nullptr ? 1 : (kv_mask[(size_t)b * lk + gk] != 0));
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = qs[r * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] += qd * ks[(sub + kTPR * i) * (DH + 1) + d];
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = sub + kTPR * i;
      // past the end: -inf, so exp() gives exactly 0
      s[i] = mask_score(s[i] * sm_scale, ms[j], qpos, k0 + j, causal, self_mask);
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = sub + kTPR * i;
      const float p = expf(s[i] - m_new);
      psum += p;  // l sums the undropped probabilities
      ps[r * (kBK + 1) + j] =
          drop_thr > 0 ? p * drop_rscale(seed, bh, qpos, k0 + j, drop_thr, drop_scale) : p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four lanes share their P entries

#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = ps[r * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += p * vs[j * DH + sub + kTPR * c];
    }
  }

  const int gq = q0 + r;
  if (gq < lq) {
    const float inv = l == 0.f ? 1.f : 1.f / l;
    T* ob = out + ((size_t)bh * lq + gq) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) ob[sub + kTPR * c] = from_f32<T>(acc[c] * inv);
    if (lse != nullptr && sub == 0) lse[(size_t)bh * lq + gq] = m + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                   void* lse, int bh, int heads, int lq, int lk, float sm_scale, int causal,
                   int self_mask, int q_offset, uint32_t seed, int drop_thr, float drop_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<T*>(out), static_cast<float*>(lse),
      heads, lq, lk, sm_scale, causal, self_mask, q_offset, seed, drop_thr, drop_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (bh, lq, dh); k, v: (bh, lk, dh);
// kv_mask: (bh / heads, lk) bytes or null; out like q; lse: (bh, lq) f32 or
// null.  drop_thr: 24-bit keep threshold, 0 = no dropout; drop_scale =
// 1 / keep_prob.  Returns the launch's cudaError_t (0 on success).
extern "C" int rtts_flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                              void* out, void* lse, int dtype, int bh, int heads, int lq, int lk,
                              int dh, float sm_scale, int causal, int self_mask, int q_offset,
                              unsigned int seed, int drop_thr, float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh == 0 || lq == 0) return (int)cudaSuccess;
#define RTTS_FWD(T, DH)                                                                    \
  return (int)launch<T, DH>(q, k, v, kv_mask, out, lse, bh, heads, lq, lk, sm_scale, causal, \
                            self_mask, q_offset, seed, drop_thr, drop_scale, s)
  if (dtype == 0 && dh == 64) RTTS_FWD(float, 64);
  if (dtype == 0 && dh == 128) RTTS_FWD(float, 128);
  if (dtype == 1 && dh == 64) RTTS_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && dh == 128) RTTS_FWD(__nv_bfloat16, 128);
#undef RTTS_FWD
  return (int)cudaErrorInvalidValue;
}
