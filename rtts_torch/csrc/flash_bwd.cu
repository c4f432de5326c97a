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
// rtts_flash_bwd_dkv owns dK/dV rows per 64-key tile and walks the query
// tiles; rtts_flash_bwd_dq owns dQ rows per 64-query tile and walks the key
// tiles.
//
// What bounds it on this card: four (dK/dV: S, dP, dV, dK) and three (dQ:
// S, dP, dQ) L x L x dh products per batch*head; at the training shapes
// (B*H = 16 to 64, L 256 to 8192, dh 64) that is 10-70 GFLOP a call, so
// the tensor cores bound it, not HBM.  Two paths:
//
// bf16 (every train config): tensor-core products, mma.sync.m16n8k16 with
// f32 accumulation, fed by ldmatrix from bf16 tiles in shared memory (rows
// padded by 16 bytes, so the eight rows of an ldmatrix hit distinct banks).
// The streamed tiles (Q and dO for dK/dV, K and V for dQ) arrive by 16-byte
// cp.async into a two-stage ring: the next tile loads while this one is
// multiplied.  Four warps; each owns 16 rows of the block's tile.  The
// dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T (keys as rows), so
// mask, hash and exp act on the accumulator fragments at their own (key,
// query) coordinates and P o R and dS^T become the A operands of dV +=
// (P o R)^T dO and dK += dS^T Q without leaving registers; the dQ kernel
// does the same with queries as rows.  Each of those A operands is split
// into two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), multiplied
// into the same accumulator.  The TPU kernel rounds each operand once
// (p_v.astype and ds.astype in _dkv_kernel and _dq_kernel), and so would
// fail the port's tolerance, which is held against the f32 plain backward:
// one bf16 rounding of dS (2^-9 relative) puts sums that cancel, as dK and
// dQ do, off by up to 4e-2 relative to max(1, |value|), while hi + lo
// (2^-16) leaves only the output's own bf16 rounding
// (tests/test_torch_flash_bf16.py).  The split exists only for that
// tolerance.  It adds two products to the four of the dK/dV kernel and one
// to the three of the dQ kernel; a build with -DRTTS_FLASH_BWD_ROUND_ONCE
// leaves the lo products out, rounding once as the TPU kernel does, and
// tools/flash_bwd_rounding_cost.py times the two builds side by side (on
// an H100 at 700 W the lo products cost 4-11% of the two kernels' device
// time; round once misses the tolerance by up to 4.4x).  The query
// range of each key tile is split across blocks where the key tiles alone
// would not fill the SMs several times over (the longform cross-attention:
// 16 key tiles x 16 heads); each split writes f32 partials of dK/dV and a
// second pass sums them in split order, so the result is the same bits on
// every run (no atomics).  Di = rowsum(o o dO) comes from a small first
// pass (dK/dV) or from the block's own rows (dQ).
//
// f32 (the card-vs-CPU checks): f32 FMAs through shared memory, 256
// threads, four per tile row; the score phase gives each thread 16 (query,
// key) entries, the accumulation phase dh/4 columns of one key row (dK,
// dV) or query row (dQ), accumulated in f32 registers.  Full f32 products:
// TF32 tensor cores would not hold the f32 tolerances.

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kB = 64;         // rows of a query tile and of a key tile
#ifdef RTTS_FLASH_BWD_ROUND_ONCE
constexpr bool kLoProducts = false;  // measurement build: one bf16 rounding
#else
constexpr bool kLoProducts = true;   // the lo halves of P o R and dS
#endif
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
  int drop_b0, drop_h0, drop_ht;  // the hashed (b, h) offsets and total heads
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
                         ? drop_rscale(a.seed, drop_bh(bh, a), qpos,
                                           gk, a.drop_thr, a.drop_scale)
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

// ---- the bf16 tensor-core path ----------------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 rows of the block's tile each
constexpr int kKeyTile = 64;      // keys owned by a dK/dV block
constexpr int kQueryTile = 64;    // queries owned by a dQ block
constexpr int kKeyStream = 64;    // keys streamed per step of the dQ kernel

template <int DH>
struct MmaTiles {
  static constexpr int kLd = DH + 8;                 // padded smem row, in bf16
  static constexpr int kBr = DH == 64 ? 64 : 32;     // queries streamed per dK/dV step
  static constexpr size_t kDkvSmem =
      sizeof(bf16) * (2 * kKeyTile + 4 * kBr) * kLd + sizeof(float) * 4 * kBr;
  static constexpr size_t kDqSmem =
      sizeof(bf16) * (2 * kQueryTile + 4 * kKeyStream) * kLd + sizeof(int) * 2 * kKeyStream;
};

// Di = rowsum(o o dO) in f32 for every (bh, query) row: DH / 8 lanes a row,
// 16 bytes each, summed across the lanes in a fixed order
template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    float* __restrict__ di, int rows) {
  constexpr int kLanes = DH / 8;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / kLanes, sub = gid % kLanes;
  float acc = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + (size_t)row * DH + sub * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + (size_t)row * DH + sub * 8);
    const bf16* op = reinterpret_cast<const bf16*>(&ov);
    const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += __bfloat162float(op[i]) * __bfloat162float(dp[i]);
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && sub == 0) di[row] = acc;
}

// The dK/dV kernel: block (key tile, query split, batch*head).  part is null
// with one split (dK, dV written as bf16), else the f32 partials
// [dK split 0 .. n-1][dV split 0 .. n-1], each (B*H, Lk, DH).
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(BwdArgs a, const float* __restrict__ di, float* __restrict__ part,
                         int tiles_per_split) {
  using Cfg = MmaTiles<DH>;
  constexpr int kLd = Cfg::kLd, kBr = Cfg::kBr, kNT = kBr / 8, kDT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kKeyTile x kLd
  bf16* vs = ks + kKeyTile * kLd;                // kKeyTile x kLd
  bf16* qs = vs + kKeyTile * kLd;                // 2 stages x kBr x kLd
  bf16* dos = qs + 2 * kBr * kLd;                // 2 stages x kBr x kLd
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kBr * kLd);  // 2 x kBr
  float* di_s = lse_s + 2 * kBr;                                  // 2 x kBr

  const int bh = blockIdx.z, b = bh / a.heads, split = blockIdx.y;
  const int k0 = blockIdx.x * kKeyTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = static_cast<const bf16*>(a.q) + (size_t)bh * a.lq * DH;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)bh * a.lk * DH;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)bh * a.lk * DH;
  const bf16* dob = static_cast<const bf16*>(a.dout) + (size_t)bh * a.lq * DH;
  const float* lse_b = a.lse + (size_t)bh * a.lq;
  const float* di_b = di + (size_t)bh * a.lq;

  load_tile_async<DH, kKeyTile, kMmaThreads>(ks, kb, k0, a.lk, tid);
  load_tile_async<DH, kKeyTile, kMmaThreads>(vs, vb, k0, a.lk, tid);
  cp_async_commit();

  // this thread's key rows kr and kr + 8 of the warp's 16
  const int kr = 16 * warp + g;
  const int mv0 = key_state(a.kv_mask, b, k0 + kr, a.lk);
  const int mv1 = key_state(a.kv_mask, b, k0 + kr + 8, a.lk);

  // this split's query tiles; causal tiles wholly above the key tile go
  const int n_qt = (a.lq + kBr - 1) / kBr;
  int it0 = split * tiles_per_split;
  const int it1 = min(n_qt, it0 + tiles_per_split);
  if (a.causal) {
    const int first_row = k0 - a.q_offset - (kBr - 1);  // the tile's last row reaches k0
    if (first_row > 0) it0 = max(it0, (first_row + kBr - 1) / kBr);
  }

  auto load_stage = [&](int stage, int it) {
    const int q0 = it * kBr;
    load_tile_async<DH, kBr, kMmaThreads>(qs + stage * kBr * kLd, qb, q0, a.lq, tid);
    load_tile_async<DH, kBr, kMmaThreads>(dos + stage * kBr * kLd, dob, q0, a.lq, tid);
    for (int r = tid; r < kBr; r += kMmaThreads) {
      const int gq = q0 + r;
      lse_s[stage * kBr + r] = gq < a.lq ? lse_b[gq] : 0.f;
      di_s[stage * kBr + r] = gq < a.lq ? di_b[gq] : 0.f;
    }
  };

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (it0 < it1) load_stage(0, it0);
  cp_async_commit();
  for (int it = it0; it < it1; ++it) {
    const int st = (it - it0) & 1;
    if (it + 1 < it1) {
      load_stage(st ^ 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * kBr * kLd;
    const bf16* dot = dos + st * kBr * kLd;
    const float* lse_t = lse_s + st * kBr;
    const float* di_t = di_s + st * kBr;
    const int q0 = it * kBr;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kBr queries
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, ks + a_off<kLd>(16 * warp, 16 * kk, lane));
      ldsm_x4(av, vs + a_off<kLd>(16 * warp, 16 * kk, lane));
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, qt + b_off<kLd>(16 * j, 16 * kk, lane));
        ldsm_x4(bd, dot + b_off<kLd>(16 * j, 16 * kk, lane));
        mma_bf16(s[2 * j], ak, bq[0], bq[1]);
        mma_bf16(s[2 * j + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * j], av, bd[0], bd[1]);
        mma_bf16(dp[2 * j + 1], av, bd[2], bd[3]);
      }
    }

    // P o R (into s) and dS^T * sm_scale (into dp) at each fragment's
    // (key, query): c0/c1 row kr, c2/c3 row kr + 8; columns 2 t4, 2 t4 + 1
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        const int gk = k0 + kr + (e >> 1) * 8, gq = q0 + c, qpos = a.q_offset + gq;
        const float x = mask_score(s[j][e] * a.sm_scale, (e >> 1) ? mv1 : mv0, qpos, gk,
                                   a.causal, a.self_mask);
        const float p = gq < a.lq ? expf(x - lse_t[c]) : 0.f;
        const float rs = a.drop_thr > 0
                             ? drop_rscale(a.seed, drop_bh(bh, a), qpos,
                                           gk, a.drop_thr, a.drop_scale)
                             : 1.f;
        float ds = p * (rs * dp[j][e] - di_t[c]);
        if (a.self_mask && qpos == gk) ds = 0.f;
        s[j][e] = p * rs;
        dp[j][e] = ds * a.sm_scale;
      }
    }

    // dV += (P o R)^T dO and dK += dS^T Q: A from the accumulators as
    // hi + lo bf16, B = dO / Q tiles through ldmatrix.trans
#pragma unroll
    for (int kq = 0; kq < kBr / 16; ++kq) {
      uint32_t pa[4], pl[4], da[4], dl[4];
      acc_to_a(pa, pl, s[2 * kq], s[2 * kq + 1]);
      acc_to_a(da, dl, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, dot + a_off<kLd>(16 * kq, 16 * nd, lane));
        ldsm_x4_trans(bq, qt + a_off<kLd>(16 * kq, 16 * nd, lane));
        mma_bf16(dv[2 * nd], pa, bo[0], bo[1]);
        mma_bf16(dv[2 * nd + 1], pa, bo[2], bo[3]);
        mma_bf16(dk[2 * nd], da, bq[0], bq[1]);
        mma_bf16(dk[2 * nd + 1], da, bq[2], bq[3]);
        if (kLoProducts) {
          mma_bf16(dv[2 * nd], pl, bo[0], bo[1]);
          mma_bf16(dv[2 * nd + 1], pl, bo[2], bo[3]);
          mma_bf16(dk[2 * nd], dl, bq[0], bq[1]);
          mma_bf16(dk[2 * nd + 1], dl, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }
  cp_async_wait<0>();  // the key tiles too, when the split had no query tile

  const size_t slab = (size_t)gridDim.z * a.lk * DH;  // one split's (B*H, Lk, DH)
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gk = k0 + kr + 8 * h;
      if (gk >= a.lk) continue;
      const size_t off = ((size_t)bh * a.lk + gk) * DH + 8 * n + 2 * t4;
      if (part == nullptr) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + off) =
            pack_bf16(dk[n][2 * h], dk[n][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + off) =
            pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(part + split * slab + off) =
            make_float2(dk[n][2 * h], dk[n][2 * h + 1]);
        *reinterpret_cast<float2*>(part + (gridDim.y + split) * slab + off) =
            make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
      }
    }
  }
}

// dK, dV = the splits' partials summed in split order, rounded to bf16;
// four values a thread
__global__ void __launch_bounds__(256)
flash_bwd_dkv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, size_t slab4, int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * slab4) return;
  const int which = i >= slab4;
  const size_t j = i - which * slab4;
  const float4* src = reinterpret_cast<const float4*>(part) + (size_t)which * n_split * slab4 + j;
  float4 acc = src[0];
  for (int s = 1; s < n_split; ++s) {
    const float4 v = src[(size_t)s * slab4];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  uint2 out;
  out.x = pack_bf16(acc.x, acc.y);
  out.y = pack_bf16(acc.z, acc.w);
  *reinterpret_cast<uint2*>((which ? dv : dk) + 4 * j) = out;
}

// The dQ kernel: block (query tile, batch*head), streaming the key tiles.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma_kernel(BwdArgs a) {
  using Cfg = MmaTiles<DH>;
  constexpr int kLd = Cfg::kLd, kBc = kKeyStream, kNT = kBc / 8, kDT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kQueryTile x kLd
  bf16* dos = qs + kQueryTile * kLd;             // kQueryTile x kLd
  bf16* ks = dos + kQueryTile * kLd;             // 2 stages x kBc x kLd
  bf16* vs = ks + 2 * kBc * kLd;                 // 2 stages x kBc x kLd
  int* ms_s = reinterpret_cast<int*>(vs + 2 * kBc * kLd);  // 2 x kBc key states

  const int bh = blockIdx.y, b = bh / a.heads;
  const int q0 = blockIdx.x * kQueryTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = static_cast<const bf16*>(a.q) + (size_t)bh * a.lq * DH;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)bh * a.lk * DH;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)bh * a.lk * DH;
  const bf16* ob = static_cast<const bf16*>(a.o) + (size_t)bh * a.lq * DH;
  const bf16* dob = static_cast<const bf16*>(a.dout) + (size_t)bh * a.lq * DH;

  load_tile_async<DH, kQueryTile, kMmaThreads>(qs, qb, q0, a.lq, tid);
  load_tile_async<DH, kQueryTile, kMmaThreads>(dos, dob, q0, a.lq, tid);
  cp_async_commit();

  // lse and Di = rowsum(o o dO) of this thread's rows qr and qr + 8: the
  // quad's four lanes each sum every fourth column pair
  const int qr = 16 * warp + g;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q0 + qr + 8 * h;
    float acc = 0.f;
    if (gq < a.lq) {
      const bf16* orow = ob + (size_t)gq * DH;
      const bf16* drow = dob + (size_t)gq * DH;
      for (int c = 2 * t4; c < DH; c += 8) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
        acc += ov.x * dv.x + ov.y * dv.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di_r[h] = acc;
    lse_r[h] = gq < a.lq ? a.lse[(size_t)bh * a.lq + gq] : 0.f;
  }

  // the key tiles: causal ones wholly above the query tile go
  int kt_end = (a.lk + kBc - 1) / kBc;
  if (a.causal) kt_end = min(kt_end, (a.q_offset + q0 + kQueryTile - 1) / kBc + 1);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBc;
    load_tile_async<DH, kBc, kMmaThreads>(ks + stage * kBc * kLd, kb, k0, a.lk, tid);
    load_tile_async<DH, kBc, kMmaThreads>(vs + stage * kBc * kLd, vb, k0, a.lk, tid);
    for (int c = tid; c < kBc; c += kMmaThreads)
      ms_s[stage * kBc + c] = key_state(a.kv_mask, b, k0 + c, a.lk);
  };

  float dq[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  if (kt_end > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_end) {
      load_stage(st ^ 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = ks + st * kBc * kLd;
    const bf16* vt_s = vs + st * kBc * kLd;
    const int* ms_t = ms_s + st * kBc;
    const int k0 = kt * kBc;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x kBc keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, qs + a_off<kLd>(16 * warp, 16 * kk, lane));
      ldsm_x4(ad, dos + a_off<kLd>(16 * warp, 16 * kk, lane));
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kt_s + b_off<kLd>(16 * j, 16 * kk, lane));
        ldsm_x4(bv, vt_s + b_off<kLd>(16 * j, 16 * kk, lane));
        mma_bf16(s[2 * j], aq, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * j], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], ad, bv[2], bv[3]);
      }
    }

    // dS * sm_scale (into dp) at each fragment's (query, key)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
        const int gq = q0 + qr + 8 * h, gk = k0 + c, qpos = a.q_offset + gq;
        const float x =
            mask_score(s[j][e] * a.sm_scale, ms_t[c], qpos, gk, a.causal, a.self_mask);
        const float p = gq < a.lq ? expf(x - lse_r[h]) : 0.f;
        const float rs = a.drop_thr > 0
                             ? drop_rscale(a.seed, drop_bh(bh, a), qpos,
                                           gk, a.drop_thr, a.drop_scale)
                             : 1.f;
        float ds = p * (rs * dp[j][e] - di_r[h]);
        if (a.self_mask && qpos == gk) ds = 0.f;
        dp[j][e] = ds * a.sm_scale;
      }
    }

    // dQ += dS K: A from the accumulators as hi + lo bf16, B = the K tile
    // through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kBc / 16; ++kc) {
      uint32_t da[4], dl[4];
      acc_to_a(da, dl, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, kt_s + a_off<kLd>(16 * kc, 16 * nd, lane));
        mma_bf16(dq[2 * nd], da, bk[0], bk[1]);
        mma_bf16(dq[2 * nd + 1], da, bk[2], bk[3]);
        if (kLoProducts) {
          mma_bf16(dq[2 * nd], dl, bk[0], bk[1]);
          mma_bf16(dq[2 * nd + 1], dl, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < kDT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + qr + 8 * h;
      if (gq >= a.lq) continue;
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dq) +
                                   ((size_t)bh * a.lq + gq) * DH + 8 * n + 2 * t4) =
          pack_bf16(dq[n][2 * h], dq[n][2 * h + 1]);
    }
  }
}

template <int DH>
cudaError_t launch_dkv_mma(const BwdArgs& a, int bh, float* di, float* part, int n_split,
                           cudaStream_t stream) {
  using Cfg = MmaTiles<DH>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::kDkvSmem);
  if (err != cudaSuccess) return err;
  const int rows = bh * a.lq;
  if (rows > 0) {
    const int threads = rows * (DH / 8);
    flash_bwd_di_kernel<DH><<<(threads + 255) / 256, 256, 0, stream>>>(
        static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), di, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_qt = (a.lq + Cfg::kBr - 1) / Cfg::kBr;
  const int tiles_per_split = (n_qt + n_split - 1) / n_split;
  dim3 grid((a.lk + kKeyTile - 1) / kKeyTile, n_split, bh);
  flash_bwd_dkv_mma_kernel<DH><<<grid, kMmaThreads, Cfg::kDkvSmem, stream>>>(
      a, di, n_split > 1 ? part : nullptr, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const size_t slab4 = (size_t)bh * a.lk * DH / 4;
  flash_bwd_dkv_reduce_kernel<<<(unsigned)((2 * slab4 + 255) / 256), 256, 0, stream>>>(
      part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), slab4, n_split);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_mma(const BwdArgs& a, int bh, cudaStream_t stream) {
  using Cfg = MmaTiles<DH>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::kDqSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + kQueryTile - 1) / kQueryTile, bh);
  flash_bwd_dq_mma_kernel<DH><<<grid, kMmaThreads, Cfg::kDqSmem, stream>>>(a);
  return cudaGetLastError();
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
                  unsigned int seed, int drop_thr, float drop_scale, int drop_b0, int drop_h0,
                  int drop_ht) {
  return BwdArgs{q, k, v, o, dout, static_cast<const float*>(lse),
                 static_cast<const uint8_t*>(kv_mask), dq, dk, dv, heads, lq, lk, sm_scale,
                 causal, self_mask, q_offset, seed, drop_thr, drop_scale, drop_b0, drop_h0,
                 drop_ht};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout: (bh, lq, dh); k, v: (bh,
// lk, dh); lse: (bh, lq) f32 from the forward; kv_mask: (bh / heads, lk)
// bytes or null; seed / drop_thr / drop_scale as in rtts_flash_fwd.  The
// dK/dV entry writes dk, dv (like k, v); the dQ entry writes dq (like q).
// bf16 tensors start on 16-byte boundaries.  The bf16 dK/dV path also
// takes scratch from the caller: di, (bh * lq) f32, and, with n_split > 1
// query splits, part, (2 * n_split * bh * lk * dh) f32; the f32 path reads
// neither (n_split 1).  Each returns the launches' cudaError_t (0 on
// success).
#define RTTS_BWD_INPUTS                                                                      \
  const void *q, const void *k, const void *v, const void *o, const void *dout,              \
      const void *lse, const void *kv_mask
#define RTTS_BWD_SCALARS                                                                     \
  int dtype, int bh, int heads, int lq, int lk, int dh, float sm_scale, int causal,          \
      int self_mask, int q_offset, unsigned int seed, int drop_thr, float drop_scale,        \
      int drop_b0, int drop_h0, int drop_ht, void *stream

extern "C" int rtts_flash_bwd_dkv(RTTS_BWD_INPUTS, void* dk, void* dv, void* di, void* part,
                                  int n_split, RTTS_BWD_SCALARS) {
  if (bh == 0 || lk == 0) return (int)cudaSuccess;
  if (n_split < 1 || (dtype == 0 && n_split != 1)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, kv_mask, nullptr, dk, dv, heads, lq, lk,
                              sm_scale, causal, self_mask, q_offset, seed, drop_thr, drop_scale,
                              drop_b0, drop_h0, drop_ht);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* di_f = static_cast<float*>(di);
  float* part_f = static_cast<float*>(part);
  if (dtype == 0 && dh == 64) return (int)launch_dkv<float, 64>(a, bh, s);
  if (dtype == 0 && dh == 128) return (int)launch_dkv<float, 128>(a, bh, s);
  if (dtype == 1 && dh == 64) return (int)launch_dkv_mma<64>(a, bh, di_f, part_f, n_split, s);
  if (dtype == 1 && dh == 128) return (int)launch_dkv_mma<128>(a, bh, di_f, part_f, n_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rtts_flash_bwd_dq(RTTS_BWD_INPUTS, void* dq, RTTS_BWD_SCALARS) {
  if (bh == 0 || lq == 0) return (int)cudaSuccess;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, kv_mask, dq, nullptr, nullptr, heads, lq,
                              lk, sm_scale, causal, self_mask, q_offset, seed, drop_thr,
                              drop_scale, drop_b0, drop_h0, drop_ht);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64) return (int)launch_dq<float, 64>(a, bh, s);
  if (dtype == 0 && dh == 128) return (int)launch_dq<float, 128>(a, bh, s);
  if (dtype == 1 && dh == 64) return (int)launch_dq_mma<64>(a, bh, s);
  if (dtype == 1 && dh == 128) return (int)launch_dq_mma<128>(a, bh, s);
  return (int)cudaErrorInvalidValue;
}
