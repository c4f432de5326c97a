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
// What bounds it on this card: at the longform decoder shape (n 16, nc 512,
// c 64, dh 64, window 128 keys, bf16) the call moves ~0.27 GB (0.082 ms of
// HBM at 3.35 TB/s) and does 17 GFLOP (0.017 ms at 989 TFLOP/s bf16): HBM
// bounds it.  Each key chunk is read by the before + 1 + after query
// chunks whose window holds it, the second time mostly from L2.  Two
// routes, chosen by the wrapper (rtts_torch/ops/lsh_attention.py::fwd_route):
//
// bf16 (every config with LSH; c 16, 32 or 64, dh 64 or 128): tensor-core
// products (mma_tiles.cuh), one block per (batch*head, query chunk), c / 16
// warps of 16 query rows.  The block copies its queries and its whole
// window (K, V, positions and validity of every offset) into shared memory
// by cp.async once, then runs the first pass of K5's dQ kernel
// (lsh_common.cuh::window_softmax_pv): S = Q K^T on mma.sync with f32 sums,
// the masks on the accumulator fragments, the joint max and sum online over
// the offsets, and O += P V with P rounded to bf16 once, as the TPU kernel
// rounds it (e.astype(v.dtype)): P >= 0, so nothing cancels, and the CPU
// emulation in tests/test_torch_tc_rounding.py holds the bf16 tolerance.
// out = O / l in bf16, lse = m + log l in f32.  At dh 64 the registers are
// capped so that four blocks of four warps share an SM (47 KB of shared
// memory each at c 64 and a 2-chunk window); at dh 128 a cap would spill.
// The first FMA design (4 threads a row, element-wise loads, P through
// shared memory) took 1.28 ms at the decoder shape.
//
// f32 (the card-vs-CPU checks): f32 FMAs through shared memory, 4 threads
// a query row (4c threads).  The block keeps its c queries in shared
// memory and loads each neighbour key/value chunk straight from its index
// (no rolled copies of k/v, the TPU wrapper's _roll_chunks, and no
// blocking of 8 chunks, the TPU's _CB); the running max, sum and output
// (dh/4 columns a thread) live in registers; the row's four lanes reduce
// with warp shuffles.  Full f32 products: TF32 would not hold the f32
// tolerance.

#include "lsh_common.cuh"

namespace {

struct FwdArgs {
  const void *q, *k, *v;
  const int* pos;
  const uint8_t* valid;
  void* out;
  float* lse;
  int n, nc, causal, before, after;
  float mask_value, self_mask_value;
};

// ---- the bf16 tensor-core path ----------------------------------------------

constexpr int kMinBlocks64 = 4;  // blocks an SM the dh 64 registers are capped for

template <int DH, int C>
size_t mma_smem_bytes(int n_off) {
  return sizeof(bf16) * (size_t)(1 + 2 * n_off) * C * (DH + 8) +
         sizeof(int) * (size_t)2 * n_off * C;
}

// Block (query chunk i, batch*head n): out and lse of its c rows.
template <int DH, int C>
__global__ void __launch_bounds__(2 * C, DH == 64 ? kMinBlocks64 : 1)
    lsh_attend_fwd_mma_kernel(FwdArgs a) {
  constexpr int kThreads = 2 * C, kLd = DH + 8, kDT = DH / 8;
  const int n_off = a.before + 1 + a.after;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // C x kLd, this block's queries
  bf16* ks = qs + C * kLd;                       // n_off x C x kLd, the window's keys
  bf16* vs = ks + n_off * C * kLd;               // n_off x C x kLd
  int* kpos_s = reinterpret_cast<int*>(vs + n_off * C * kLd);  // n_off x C
  int* kval_s = kpos_s + n_off * C;                           // n_off x C

  const int n = blockIdx.y, i = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const size_t row0 = ((size_t)n * a.nc + i) * C;

  load_tile_async<DH, C, kThreads>(qs, static_cast<const bf16*>(a.q) + row0 * DH, 0, C, tid);
  load_window<DH, C, kThreads>(ks, vs, kpos_s, kval_s, static_cast<const bf16*>(a.k),
                               static_cast<const bf16*>(a.v), a.pos, a.valid, n, a.nc, i,
                               a.before, n_off, tid);
  cp_async_commit();
  const int qr = 16 * warp + (lane >> 2);  // this thread's rows qr and qr + 8
  const int qpos[2] = {a.pos[row0 + qr], a.pos[row0 + qr + 8]};
  cp_async_wait<0>();
  __syncthreads();

  float m[2], l[2], acc[kDT][4];
  window_softmax_pv<DH, C, false>(acc, m, l, qs, ks, vs, kpos_s, kval_s, qpos, n_off, a, warp,
                                  lane);
  // every row holds its own position, so its max entry gives l >= 1
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv_l[h] = 1.f / l[h];
    if (t4 == 0) a.lse[row0 + qr + 8 * h] = m[h] + logf(l[h]);
  }
  store_acc_rows<DH>(static_cast<bf16*>(a.out) + row0 * DH, acc, qr, C, inv_l, lane);
}

template <int DH, int C>
cudaError_t launch_mma(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DH, C>(a.before + 1 + a.after);
  cudaError_t err = cudaFuncSetAttribute(lsh_attend_fwd_mma_kernel<DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nc, a.n);
  lsh_attend_fwd_mma_kernel<DH, C><<<grid, 2 * C, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- the f32 path -------------------------------------------------------------

constexpr int kTPR = 4;           // threads per query row
constexpr float kNegInit = -1e30f;

template <int DH, int C>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (2 * C * (DH + 1) + C * DH + C * (C + 1)) + sizeof(int) * 2 * C;
}

template <int DH, int C>
__global__ void __launch_bounds__(C * kTPR) lsh_attend_fwd_fma_kernel(FwdArgs a) {
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

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int n = blockIdx.y, i = blockIdx.x, nc = a.nc;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int sub = tid % kTPR;
  const size_t row0 = ((size_t)n * nc + i) * C;   // first row of the query chunk

  for (int e = tid; e < C * DH; e += kThreads) {
    const int rr = e / DH, c = e % DH;
    qs[rr * (DH + 1) + c] = q[row0 * DH + e];
  }
  const int qpos = a.pos[row0 + r];

  float m = kNegInit, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  for (int off = -a.before; off <= a.after; ++off) {
    const size_t key0 = ((size_t)n * nc + wrap_chunk(i + off, nc)) * C;
    __syncthreads();  // the previous chunk's K/V/P are no longer read
    for (int e = tid; e < C * DH; e += kThreads) {
      const int jj = e / DH, c = e % DH;
      ks[jj * (DH + 1) + c] = k[key0 * DH + e];
      vs[jj * DH + c] = v[key0 * DH + e];
    }
    if (tid < C) {
      kpos_s[tid] = a.pos[key0 + tid];
      kval_s[tid] = a.valid[key0 + tid];
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
      s[t] = lsh_mask(s[t], kval_s[jj], qpos, kpos_s[jj], a);
      tmax = fmaxf(tmax, s[t]);
    }
    const float m_new = fmaxf(m, quad_max(tmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const float p = expf(s[t] - m_new);
      psum += p;
      ps[r * (C + 1) + sub + kTPR * t] = p;
    }
    l = l * alpha + quad_sum(psum);
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

  const float inv = 1.f / l;
  float* ob = static_cast<float*>(a.out) + (row0 + r) * DH;
#pragma unroll
  for (int c = 0; c < CPT; ++c) ob[sub + kTPR * c] = acc[c] * inv;
  if (sub == 0) a.lse[row0 + r] = m + logf(l);
}

template <int DH, int C>
cudaError_t launch_fma(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<DH, C>();
  cudaError_t err = cudaFuncSetAttribute(lsh_attend_fwd_fma_kernel<DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nc, a.n);
  lsh_attend_fwd_fma_kernel<DH, C><<<grid, C * kTPR, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// mma: 1 = the tensor-core kernel (bf16 only), 0 = the f32 FMA kernel (f32
// only); dtype: 0 = float32, 1 = bfloat16.  q, k, v, out: (n, nc, c, dh),
// bf16 ones on 16-byte boundaries; pos: (n, nc, c) int32 original
// positions; valid: (n, nc, c) bytes; lse: (n, nc, c) f32.  c in {16, 32,
// 64}, dh in {64, 128}.  Returns the launch's cudaError_t (0 on success).
extern "C" int rtts_lsh_attend_fwd(const void* q, const void* k, const void* v, const void* pos,
                                   const void* valid, void* out, void* lse, int mma, int dtype,
                                   int n, int nc, int c, int dh, int causal, int before,
                                   int after, float mask_value, float self_mask_value,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nc == 0) return (int)cudaSuccess;
  if (before < 0 || after < 0 || (dtype != 0 && dtype != 1) || mma != (dtype == 1))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, static_cast<const int*>(pos), static_cast<const uint8_t*>(valid),
                  out, static_cast<float*>(lse), n, nc, causal, before, after, mask_value,
                  self_mask_value};
#define RTTS_LSH_FWD(LAUNCH, DH, C) \
  if (dh == DH && c == C) return (int)LAUNCH<DH, C>(a, s)
#define RTTS_LSH_FWD_C(LAUNCH, DH) \
  RTTS_LSH_FWD(LAUNCH, DH, 16);    \
  RTTS_LSH_FWD(LAUNCH, DH, 32);    \
  RTTS_LSH_FWD(LAUNCH, DH, 64)
  if (mma) {
    RTTS_LSH_FWD_C(launch_mma, 64);
    RTTS_LSH_FWD_C(launch_mma, 128);
  } else {
    RTTS_LSH_FWD_C(launch_fma, 64);
    RTTS_LSH_FWD_C(launch_fma, 128);
  }
#undef RTTS_LSH_FWD_C
#undef RTTS_LSH_FWD
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's resources at (dh, c) and a window of n_off chunks:
// out[0..3] (kernel_resources).  Returns the cudaError_t.
extern "C" int rtts_lsh_attend_fwd_resources(int dh, int c, int n_off, int* out) {
  if (n_off < 1) return (int)cudaErrorInvalidValue;
#define RTTS_LSH_RES(DH, C)                                                            \
  if (dh == DH && c == C)                                                              \
  return (int)kernel_resources(lsh_attend_fwd_mma_kernel<DH, C>, 2 * C,                \
                               mma_smem_bytes<DH, C>(n_off), out)
  RTTS_LSH_RES(64, 16);
  RTTS_LSH_RES(64, 32);
  RTTS_LSH_RES(64, 64);
  RTTS_LSH_RES(128, 16);
  RTTS_LSH_RES(128, 32);
  RTTS_LSH_RES(128, 64);
#undef RTTS_LSH_RES
  return (int)cudaErrorInvalidValue;
}
