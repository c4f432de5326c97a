// Flash-attention forward (online softmax) for Hopper, sm_90a: kernel K1.
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
// TPU wrapper's pad-to-128 copy is not needed.  Causal key tiles wholly
// after the block's last query row are skipped, as the TPU kernel's pl.when
// does.
//
// Attention-probs dropout (drop_thr > 0) is the TPU kernel's counter hash,
// bit for bit (flash_common.cuh::keep): the keep bit of (bh, global row,
// global col) is regenerated here and in both backward kernels
// (flash_bwd.cu), so no mask is stored.  It applies to P.V only: m, l and
// lse are those of the undropped softmax.
//
// What bounds it on this card: two L x L x dh products per batch*head
// (S = QK^T, then P.V).  At the serving shape (B*H 64, L 256, dh 64) that
// is 1.1 GFLOP over 8 MB; at the longform cross-attention (B*H 16, 8192 x
// 1024) 34 GFLOP over 37 MB: by the roofline the tensor cores' 989
// TFLOP/s bound it, and at the small shapes the launch does.  It runs well
// above that bound, and slower than F.scaled_dot_product_attention's
// forward at the cross-attention.  What holds it there is not measured: no
// stall reason can be read on the card's machine.  The guess is the
// per-element softmax work beside the products (masks, exp, max and sum,
// the bf16 packing), with 16 warps an SM to hide its latencies
// (chip_smoke.py prints the registers, shared memory and blocks an SM that
// the runtime reports).  Two paths:
//
// bf16 (every model config): both products on mma.sync.m16n8k16 with f32
// accumulation (mma_tiles.cuh).  A block of four warps owns 64 query rows,
// 16 a warp, and holds its Q tile in registers as A fragments for the whole
// key loop.  K and V tiles of 64 keys arrive by 16-byte cp.async into a
// two-stage ring (the next tile loads while this one multiplies) and feed
// the B operands through ldmatrix (V through .trans).  S stays in the
// accumulator fragments: masks, the keep hash and exp (on the SFU, as
// exp2) run at each element's own (row, col), the row max and sum reduce
// across the quad of lanes that share a row, and P o R goes from the
// accumulators straight to the A operand of O += (P o R) V, rounded to
// bf16 once as the TPU kernel does (p_v.astype(v.dtype)): P >= 0, so P.V
// sums nothing that cancels, and one rounding holds the port's bf16
// tolerance (tests/test_torch_tc_rounding.py emulates it at the phase-3
// and phase-7 shapes).  A tile whose keys are all valid and that neither
// diagonal crosses skips the masks.  At dh 64 the registers are capped at
// 128 so that four blocks (16 warps) share an SM instead of three; at dh
// 128 the cap would spill.  Four warps of 16 rows, not eight: eight ran no
// faster at the cross-attention and slower at the decoder's shape.
//
// f32 (the card-vs-CPU checks): one 256-thread block per (batch*head,
// 64-row query tile); K/V tiles of 64 rows staged in shared memory as f32,
// four threads own one query row (16 keys of each tile for the scores,
// dh/4 output columns for P.V), the row max and sum reduced across those
// four lanes with warp shuffles.  Full f32 FMAs: TF32 tensor cores would
// not hold the f32 tolerance.  No L x L tensor is written on either path.

#include "flash_common.cuh"
#include "mma_tiles.cuh"

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

// ---- the bf16 tensor-core path ----------------------------------------------

// Four warps of 16 rows; at dh 64 the registers are capped so that four
// blocks share an SM (dh 128 would spill).
constexpr int kMmaWarps = 4;
constexpr int kMinBlocks64 = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows a block
constexpr int kMmaBK = 64;              // keys a streamed tile
// a tile's key states are written and tested by one thread each
static_assert(kMmaThreads >= kMmaBK, "fewer threads than keys a tile");

struct FwdArgs {
  const bf16 *q, *k, *v;
  const uint8_t* kv_mask;
  bf16* out;
  float* lse;
  int heads, lq, lk;
  float sm_scale;
  int causal, self_mask, q_offset;
  uint32_t seed;
  int drop_thr;
  float drop_scale;
};

template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kMmaBQ + 4 * kMmaBK) * (DH + 8) + sizeof(int) * 2 * kMmaBK;
}

// Block (query tile, batch*head); warp w owns rows 16 w .. 16 w + 15.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, DH == 64 ? kMinBlocks64 : 1)
    flash_fwd_mma_kernel(FwdArgs a) {
  constexpr int kLd = DH + 8, kNT = kMmaBK / 8, kDT = DH / 8, kKS = DH / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kMmaBQ x kLd
  bf16* ks = qs + kMmaBQ * kLd;                  // 2 stages x kMmaBK x kLd
  bf16* vs = ks + 2 * kMmaBK * kLd;              // 2 stages x kMmaBK x kLd
  int* ms_s = reinterpret_cast<int*>(vs + 2 * kMmaBK * kLd);  // 2 x kMmaBK key states

  const int bh = blockIdx.y, b = bh / a.heads, q0 = blockIdx.x * kMmaBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kb = a.k + (size_t)bh * a.lk * DH;
  const bf16* vb = a.v + (size_t)bh * a.lk * DH;

  load_tile_async<DH, kMmaBQ, kMmaThreads>(qs, a.q + (size_t)bh * a.lq * DH, q0, a.lq, tid);
  cp_async_commit();

  // the key tiles: causal ones wholly after the block's last row go
  int kt_end = (a.lk + kMmaBK - 1) / kMmaBK;
  if (a.causal) kt_end = min(kt_end, (a.q_offset + q0 + kMmaBQ - 1) / kMmaBK + 1);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kMmaBK;
    load_tile_async<DH, kMmaBK, kMmaThreads>(ks + stage * kMmaBK * kLd, kb, k0, a.lk, tid);
    load_tile_async<DH, kMmaBK, kMmaThreads>(vs + stage * kMmaBK * kLd, vb, k0, a.lk, tid);
    for (int c = tid; c < kMmaBK; c += kMmaThreads)
      ms_s[stage * kMmaBK + c] = key_state(a.kv_mask, b, k0 + c, a.lk);
  };

  // this thread's rows qr and qr + 8: running max, partial sum (its own
  // columns; the quad's four are summed at the end) and unnormalised O
  const int qr = 16 * warp + g;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qa[kKS][4];  // the warp's Q rows as A fragments

  // the block's query positions, against which a tile's keys are masked
  const int q_lo = a.q_offset + q0, q_hi = q_lo + kMmaBQ - 1;

  if (kt_end > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    const int* ms_t = ms_s + st * kMmaBK;
    const int k0 = kt * kMmaBK;
    if (kt + 1 < kt_end) {
      load_stage(st ^ 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the barrier, and whether every key of the tile is valid (thread c
    // wrote ms_t[c] itself); only then, and off the causal and self
    // diagonals, does the tile skip the masks
    const bool keys_valid = __syncthreads_and(tid >= kMmaBK || ms_t[tid] == 1);
    const bool plain_tile = keys_valid && !(a.causal && k0 + kMmaBK - 1 > q_lo) &&
                            !(a.self_mask && k0 <= q_hi && q_lo <= k0 + kMmaBK - 1);
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) ldsm_x4(qa[kk], qs + a_off<kLd>(16 * warp, 16 * kk, lane));
    }

    // S = Q K^T: the warp's 16 rows x 64 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + st * kMmaBK * kLd + b_off<kLd>(16 * j, 16 * kk, lane));
        mma_bf16(s[2 * j], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // masks at each element's (row, col), then the rows' running max
    float tmax[2] = {-INFINITY, -INFINITY};
    if (plain_tile) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= a.sm_scale;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
          s[j][e] = mask_score(s[j][e] * a.sm_scale, ms_t[c], q_lo + qr + 8 * h, k0 + c,
                               a.causal, a.self_mask);
          tmax[h] = fmaxf(tmax[h], s[j][e]);
        }
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
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // P (l sums it undropped), then P o R in place of S
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = exp_fast(s[j][e] - m[h]);
        l[h] += p;
        s[j][e] = a.drop_thr > 0
                      ? p * drop_rscale(a.seed, bh, q_lo + qr + 8 * h,
                                        k0 + 8 * j + 2 * t4 + (e & 1), a.drop_thr, a.drop_scale)
                      : p;
      }
    }

    // O += (P o R) V
    warp_acc_xb<DH, kMmaBK, false>(o, s, vs + st * kMmaBK * kLd, lane);
    __syncthreads();  // this stage is reloaded two tiles on
  }
  cp_async_wait<0>();  // the Q tile too, when no key tile ran

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
  }
  bf16* ob = a.out + (size_t)bh * a.lq * DH;
  store_acc_rows<DH>(ob, o, q0 + qr, a.lq, inv, lane);
  if (a.lse != nullptr && t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + qr + 8 * h;
      if (gq < a.lq) a.lse[(size_t)bh * a.lq + gq] = m[h] + logf(l[h] == 0.f ? 1.f : l[h]);
    }
  }
}

template <int DH>
cudaError_t launch_mma(const FwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + kMmaBQ - 1) / kMmaBQ, bh);
  flash_fwd_mma_kernel<DH><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (bf16 tensors start on 16-byte
// boundaries).  q: (bh, lq, dh); k, v: (bh, lk, dh);
// kv_mask: (bh / heads, lk) bytes or null; out like q; lse: (bh, lq) f32 or
// null.  drop_thr: 24-bit keep threshold, 0 = no dropout; drop_scale =
// 1 / keep_prob.  Returns the launch's cudaError_t (0 on success).
extern "C" int rtts_flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                              void* out, void* lse, int dtype, int bh, int heads, int lq, int lk,
                              int dh, float sm_scale, int causal, int self_mask, int q_offset,
                              unsigned int seed, int drop_thr, float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh == 0 || lq == 0) return (int)cudaSuccess;
#define RTTS_FWD(DH)                                                                           \
  return (int)launch<float, DH>(q, k, v, kv_mask, out, lse, bh, heads, lq, lk, sm_scale, causal, \
                                self_mask, q_offset, seed, drop_thr, drop_scale, s)
  if (dtype == 0 && dh == 64) RTTS_FWD(64);
  if (dtype == 0 && dh == 128) RTTS_FWD(128);
#undef RTTS_FWD
  const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_mask),
                  static_cast<bf16*>(out), static_cast<float*>(lse), heads, lq, lk, sm_scale,
                  causal, self_mask, q_offset, seed, drop_thr, drop_scale};
  if (dtype == 1 && dh == 64) return (int)launch_mma<64>(a, bh, s);
  if (dtype == 1 && dh == 128) return (int)launch_mma<128>(a, bh, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's resources at dh 64 or 128 (kernel_resources: out[0..3]
// = registers a thread, spill bytes a thread, dynamic shared bytes a
// block, blocks an SM).  Returns the cudaError_t.
extern "C" int rtts_flash_fwd_resources(int dh, int* out) {
  if (dh == 64)
    return (int)kernel_resources(flash_fwd_mma_kernel<64>, kMmaThreads, mma_smem_bytes<64>(), out);
  if (dh == 128)
    return (int)kernel_resources(flash_fwd_mma_kernel<128>, kMmaThreads, mma_smem_bytes<128>(),
                                 out);
  return (int)cudaErrorInvalidValue;
}
