// Fused LayerNorm + feed-forward for Hopper, sm_90a: kernel K6.
//
// Replaces the TPU kernel rtts/ops/chunked_ffn.py::_ffn_kernel (launched by
// _ffn_pallas_raw through chunked_ffn_pallas).  Same contract, per row of
// x (n, d):
//
//   h   = LayerNorm(x) * scale + bias             f32, eps given (1e-5)
//   mid = act(round(h) . round(W_in) + b_in)      products summed in f32
//   out = round(mid) . round(W_out) + b_out       products summed in f32
//
// round() casts to the multiply dtype (bf16 or f32).  Weights and biases
// are f32; out has x's dtype.  act: 0 relu, 1 tanh-GELU, 2 tanh, 3 silu.
// The (n, d_ff) intermediate never reaches device memory, which is what
// the TPU kernel exists for.
//
// What bounds it on this card: 4 n d f operations against ~4 (2 n d + 2 d f)
// bytes, so at the decoder's 8192 rows x 512 -> 2048 it is bound by the
// operations (34 GFLOP: 0.035 ms at 989 TFLOP/s bf16, 0.51 ms at 67 TFLOP/s
// f32).  The weights cannot stay resident as in the TPU's VMEM (4 MB in
// bf16 at 512 x 2048): every block streams them from L2, so the rows a
// block owns set the operations per L2 byte (64 rows: 64 flop a byte).
// Two routes, chosen by the wrapper (rtts_torch/ops/chunked_ffn.py::
// ffn_route):
//
// bf16 multiplies: tensor cores (mma.sync m16n8k16, bf16 operands, f32
// sums; mma_tiles.cuh).  They round h, the weights and the activated mid
// once each, as the TPU kernel does, so only the order of the sums
// differs.  A first kernel casts W_in and W_out to bf16 once per call into
// scratch the wrapper allocates, zero-padded to the (dp, fp) it chose and
// passes in (the TPU kernel casts inside; here that is one pass over the
// f32 weights instead of one per block, and no copy is kept across calls).  The main kernel
// takes BM = 64, 32 or 16 rows a block (the wrapper halves the tile while
// the halved tile's grid still fits on the SMs in one wave: 64 at 8192
// rows, 16 at the encoder's 2048), 8 warps of 32 rows (16 at BM 16), so
// each B fragment read from shared memory feeds two products.  The block
// normalises its rows in f32 (two passes, as the TPU kernel) into shared
// memory as bf16, then walks d_ff in tiles of 128: each warp computes its
// rows x (a column group's share) of the hidden tile on tensor cores, adds
// b_in and the activation in f32 registers and rounds them once into a
// shared bf16 tile; then each warp multiplies its rows of that tile into
// its share of the output columns, whose f32 accumulators stay in
// registers for the whole walk (at most 2 m-tiles x 16 n-tiles, 128
// floats a thread).  The weight tiles arrive by cp.async through a ring
// of 4 slots (a slot holds 64 rows of W_in's tile or 16 rows of W_out),
// one __syncthreads a slot, with no division by a runtime value in the
// walk (a first version's integer divisions were a large part of each
// slab's fixed cost).  One block an SM at 64 and 32 rows (registers,
// 112-207 KB of shared memory); widths up to 1024 (BM 64 only up to 512),
// any row count and any d_ff.  On the card a block's own walk sets the
// time, not L2: it does not change from 16 to 128 blocks of 64 rows.
//
// f32 multiplies (the card-vs-CPU checks): f32 FMAs through shared memory,
// one block of 256 threads per 32 rows, the normalised rows K-major in
// shared memory, the (32, 256) hidden tile from weight slabs of 16 rows,
// the (32, d) output in registers.  Full f32 products: TF32 would not hold
// the f32 tolerance.

#include <math.h>

#include "mma_tiles.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 0:
      return fmaxf(x, 0.f);
    case 1:  // jax.nn.gelu's tanh form
      return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case 2:
      return tanhf(x);
    default:
      return x / (1.f + expf(-x));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of row `row` of x (d values), two passes as the TPU kernel:
// the mean, then the mean of the squared deviations; the warp's lanes take
// every 32nd column.  Returns (mean, 1 / sqrt(var + eps)).
template <typename T>
__device__ __forceinline__ float2 ln_stats(const T* xr, int d, float eps, int lane) {
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / d;
  float v = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = to_f32(xr[c]) - mean;
    v += t * t;
  }
  return make_float2(mean, 1.f / sqrtf(warp_sum(v) / d + eps));
}

// ---- the bf16 tensor-core path ----------------------------------------------

constexpr int kFT = 128;           // hidden columns a d_ff tile
constexpr int kLdF = kFT + 8;      // row stride of W_in's slabs and of the hidden tile
constexpr int kKS1 = 64;           // W_in rows a ring slot
constexpr int kKS2 = 16;           // W_out rows a ring slot
constexpr int kStages = 4;         // ring slots
constexpr int kMmaThreads = 256;   // 8 warps
constexpr int kOutTiles = 16;      // output n-tiles of 8 columns a warp holds, most

// ring slot size in bf16 values: a W_in slab (kKS1 x kLdF) or a W_out slab
// (kKS2 x (dp + 8)), the larger
__host__ __device__ __forceinline__ int slot_elems(int dp) {
  return kKS1 * kLdF > kKS2 * (dp + 8) ? kKS1 * kLdF : kKS2 * (dp + 8);
}

size_t mma_smem_bytes(int bm, int dp) {
  return sizeof(bf16) *
         ((size_t)bm * (dp + 8) + (size_t)bm * kLdF + (size_t)kStages * slot_elems(dp));
}

// W_in (d, f) and W_out (f, d) f32 -> bf16 scratch (dp, fp) and (fp, dp),
// zeros in the padding
__global__ void ffn_fused_cast_kernel(const float* __restrict__ w_in,
                                      const float* __restrict__ w_out, bf16* __restrict__ win_b,
                                      bf16* __restrict__ wout_b, int d, int f, int dp, int fp) {
  const size_t total = (size_t)dp * fp;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / fp), c = (int)(e % fp);
    win_b[e] = __float2bfloat16(r < d && c < f ? w_in[(size_t)r * f + c] : 0.f);
    const int r2 = (int)(e / dp), c2 = (int)(e % dp);
    wout_b[e] = __float2bfloat16(r2 < f && c2 < d ? w_out[(size_t)r2 * d + c2] : 0.f);
  }
}

// Block: BM = 16 MT RG rows of x.  Warp w: row group w % RG (16 MT rows,
// MT m-tiles of 16, so each B fragment it loads feeds MT products), column
// group cg = w / RG of CG = 8 / RG: hidden columns cg 128 / CG .. of each
// tile, output columns cg dp / CG .. (nt = dp / (8 CG) n-tiles, <= kOutTiles).
// No division by a runtime value in the walk: the loads follow a cursor,
// and every address offset is worked out once.
template <typename T, int MT, int RG>
__global__ void __launch_bounds__(kMmaThreads, 1)
    ffn_fused_mma_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                         const float* __restrict__ ln_bias, const bf16* __restrict__ w_in,
                         const float* __restrict__ b_in, const bf16* __restrict__ w_out,
                         const float* __restrict__ b_out, T* __restrict__ out, int n, int d,
                         int f, int dp, int fp, int act, float eps) {
  constexpr int WR = 16 * MT, BM = WR * RG, CG = 8 / RG;
  constexpr int kHC = kFT / CG;   // hidden columns a warp computes per tile
  constexpr int kHT = kHC / 8;    // and their n-tiles
  constexpr int kInChunks = kFT / 8;  // 16-byte chunks of a W_in slab row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = dp + 8;          // row stride of the normalised rows and W_out's slabs
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);  // BM x ld: normalised rows, bf16
  bf16* mid = hs + BM * ld;                      // BM x kLdF: the activated hidden tile
  bf16* ring = mid + BM * kLdF;                  // kStages slots
  const int slot = slot_elems(dp);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = WR * (warp % RG), cg = warp / RG;  // this warp's first row, column group
  const int g = lane >> 2, t4 = lane & 3;
  const long long row0 = (long long)blockIdx.x * BM;
  const int nt = dp / (8 * CG);
  const int oc0 = cg * (dp / CG);      // this warp's first output column
  const int s1 = dp / kKS1;            // W_in slabs a tile; then kFT / kKS2 W_out slabs
  const int per_tile = s1 + kFT / kKS2;
  const int tiles = fp / kFT, n_slabs = tiles * per_tile;

  // this thread's share of a slab copy: W_in rows in_r + 16 i, chunk
  // in_ch; W_out rows out_r, out_r + out_step, ..., chunk out_ch (threads
  // past out_step whole rows of chunks copy nothing)
  const int in_r = tid / kInChunks, in_ch = tid % kInChunks;
  const int out_chunks = dp / 8, out_step = kMmaThreads / out_chunks;
  const int out_r = tid / out_chunks, out_ch = tid % out_chunks;
  // the walk's next slab to load: tile l_t, slab l_j of it, ring slot l_slot
  int l_t = 0, l_j = 0, l_slot = 0, l_left = n_slabs;
  auto load_next = [&]() {
    bf16* dst = ring + l_slot * slot;
    if (l_j < s1) {
      const bf16* src = w_in + (size_t)(l_j * kKS1 + in_r) * fp + l_t * kFT + in_ch * 8;
#pragma unroll
      for (int i = 0; i < kKS1 * kInChunks / kMmaThreads; ++i)
        cp_async16(dst + (in_r + i * (kMmaThreads / kInChunks)) * kLdF + in_ch * 8,
                   src + (size_t)i * (kMmaThreads / kInChunks) * fp, true);
    } else if (out_r < out_step) {
      const bf16* src = w_out + (size_t)(l_t * kFT + (l_j - s1) * kKS2) * dp + out_ch * 8;
      for (int r = out_r; r < kKS2; r += out_step)
        cp_async16(dst + r * ld + out_ch * 8, src + (size_t)r * dp, true);
    }
    if (++l_j == per_tile) {
      l_j = 0;
      ++l_t;
    }
    l_slot = l_slot == kStages - 1 ? 0 : l_slot + 1;
    --l_left;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (l_left > 0) load_next();
    cp_async_commit();
  }

  // LayerNorm of the block's rows (warp w: rows w, w + 8, ...), rounded to
  // bf16 once; zeros past d and for rows past n
  for (int r = warp; r < BM; r += kMmaThreads / 32) {
    const long long row = row0 + r;
    bf16* hr = hs + r * ld;
    if (row < n) {
      const T* xr = x + row * d;
      const float2 st = ln_stats(xr, d, eps, lane);
      for (int c = lane; c < dp; c += 32)
        hr[c] = __float2bfloat16(
            c < d ? (to_f32(xr[c]) - st.x) * st.y * ln_scale[c] + ln_bias[c] : 0.f);
    } else {
      for (int c = lane; c < dp; c += 32) hr[c] = __float2bfloat16(0.f);
    }
  }

  // ldmatrix offsets of this lane: A of the normalised rows (per m-tile)
  // and of the hidden tile, B of a W_in slab and of a W_out slab
  const int a_hs = (r0 + (lane & 15)) * ld + (lane >> 4) * 8;
  const int a_mid = a_off<kLdF>(r0, 0, lane);
  const int b_in_off = a_off<kLdF>(0, cg * kHC, lane);
  const int b_out_off = (lane & 15) * ld + oc0 + (lane >> 4) * 8;

  float acc[MT][kOutTiles][4], hacc[MT][kHT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  int c_slot = 0;  // the ring slot of the slab computed now
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < kHT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[mt][jj][e] = 0.f;
    for (int j = 0; j < per_tile; ++j) {
      // this slab has landed and every warp is done with the previous one,
      // whose slot the next load reuses (and, at a tile's first W_out
      // slab, every warp's part of the hidden tile is in shared memory)
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (l_left > 0) load_next();
      cp_async_commit();
      const bf16* sl = ring + c_slot * slot;
      c_slot = c_slot == kStages - 1 ? 0 : c_slot + 1;
      if (j < s1) {
        // hidden (WR x kHC) += h[rows, j kKS1 ..] W_in[j kKS1 .., columns]
#pragma unroll
        for (int kk = 0; kk < kKS1 / 16; ++kk) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], hs + a_hs + 16 * mt * ld + j * kKS1 + 16 * kk);
#pragma unroll
          for (int jj = 0; jj < kHT / 2; ++jj) {
            uint32_t b[4];
            ldsm_x4_trans(b, sl + b_in_off + 16 * kk * kLdF + 16 * jj);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(hacc[mt][2 * jj], a[mt], b[0], b[1]);
              mma_bf16(hacc[mt][2 * jj + 1], a[mt], b[2], b[3]);
            }
          }
        }
        if (j == s1 - 1) {
          // b_in and the activation in f32, rounded once into the shared
          // tile; columns past d_ff are zeros (their W_out rows are too)
#pragma unroll
          for (int jj = 0; jj < kHT; ++jj) {
            const int cl = cg * kHC + 8 * jj + 2 * t4, col = t * kFT + cl;
            const float b0 = col < f ? b_in[col] : 0.f, b1 = col + 1 < f ? b_in[col + 1] : 0.f;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v0 = col < f ? activate(hacc[mt][jj][2 * h] + b0, act) : 0.f;
                const float v1 = col + 1 < f ? activate(hacc[mt][jj][2 * h + 1] + b1, act) : 0.f;
                *reinterpret_cast<uint32_t*>(mid + (r0 + 16 * mt + g + 8 * h) * kLdF + cl) =
                    pack_bf16(v0, v1);
              }
          }
        }
      } else {
        // out[rows, this warp's columns] += mid[rows, slab's k] W_out[slab's k, columns]
#pragma unroll
        for (int kk = 0; kk < kKS2 / 16; ++kk) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], mid + a_mid + 16 * mt * kLdF + (j - s1) * kKS2 + 16 * kk);
#pragma unroll
          for (int jj = 0; jj < kOutTiles / 2; ++jj) {
            if (2 * jj < nt) {
              uint32_t b[4];
              ldsm_x4_trans(b, sl + b_out_off + 16 * kk * ld + 16 * jj);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(acc[mt][2 * jj], a[mt], b[0], b[1]);
                mma_bf16(acc[mt][2 * jj + 1], a[mt], b[2], b[3]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int jj = 0; jj < kOutTiles; ++jj) {
    if (jj >= nt) continue;
    const int col = oc0 + 8 * jj + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + r0 + 16 * mt + g + 8 * h;
        if (row >= n) continue;
        if (col < d) out[row * d + col] = from_f32<T>(acc[mt][jj][2 * h] + b_out[col]);
        if (col + 1 < d)
          out[row * d + col + 1] = from_f32<T>(acc[mt][jj][2 * h + 1] + b_out[col + 1]);
      }
  }
}

// the instance of a row tile (64, 32 or 16 rows a block): 64 and 32 rows
// as warps of 32 rows (2 x 4 and 1 x 8 warps), 16 rows as warps of 16;
// every instance holds at most kOutTiles output n-tiles a warp per m-tile
template <typename T>
auto mma_kernel(int rows) {
  return rows == 64 ? &ffn_fused_mma_kernel<T, 2, 2>
                    : rows == 32 ? &ffn_fused_mma_kernel<T, 2, 1> : &ffn_fused_mma_kernel<T, 1, 1>;
}

// whether a row tile's instance takes the padded width dp: a whole number
// of W_in slabs, and nt = dp / (8 CG) <= kOutTiles (CG 4 at 64 rows, else 8)
bool tile_takes(int rows, int dp) {
  const int cg = rows == 64 ? 4 : 8;
  return (rows == 64 || rows == 32 || rows == 16) && dp % kKS1 == 0 &&
         dp <= kOutTiles * 8 * cg;
}

template <typename T>
cudaError_t launch_mma(const void* x, const void* ln_scale, const void* ln_bias,
                       const void* w_in, const void* b_in, const void* w_out, const void* b_out,
                       void* out, void* scratch, int n, int d, int f, int dp, int fp, int rows,
                       int act, float eps, cudaStream_t stream) {
  if (!tile_takes(rows, dp) || dp < d || fp < f || fp % kFT != 0) return cudaErrorInvalidValue;
  bf16* win_b = static_cast<bf16*>(scratch);
  bf16* wout_b = win_b + (size_t)dp * fp;
  const size_t cast_blocks = ((size_t)dp * fp + kMmaThreads - 1) / kMmaThreads;
  ffn_fused_cast_kernel<<<(unsigned)(cast_blocks < 4096 ? cast_blocks : 4096), kMmaThreads, 0,
                          stream>>>(static_cast<const float*>(w_in),
                                    static_cast<const float*>(w_out), win_b, wout_b, d, f, dp,
                                    fp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = mma_kernel<T>(rows);
  const size_t smem = mma_smem_bytes(rows, dp);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + rows - 1) / rows);
  kernel<<<blocks, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), win_b, static_cast<const float*>(b_in), wout_b,
      static_cast<const float*>(b_out), static_cast<T*>(out), n, d, f, dp, fp, act, eps);
  return cudaGetLastError();
}

// ---- the f32 path -------------------------------------------------------------

constexpr int kRows = 32;       // rows of x per block
constexpr int kThreads = 256;   // 8 warps; warp w owns rows 4w..4w+3
constexpr int kTile = 256;      // hidden columns per d_ff tile = output columns per chunk
constexpr int kSlab = 16;       // weight rows staged per step
constexpr int kLd = kRows + 4;  // stride of the K-major tiles: float4-aligned rows
constexpr int kMaxChunks = 4;   // output chunks of 256: d <= 1024

size_t fma_smem_bytes(int d) {
  return sizeof(float) * ((size_t)d * kLd + (size_t)kTile * kLd + (size_t)kSlab * kTile);
}

// one block per SM at the widths that matter (its shared memory), so the
// registers may go up to 255 a thread: without the minimum of 1, ptxas
// capped the d 512 instance at 128 registers and spilled its accumulators
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads, 1)
ffn_fused_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                 const float* __restrict__ ln_bias, const float* __restrict__ w_in,
                 const float* __restrict__ b_in, const float* __restrict__ w_out,
                 const float* __restrict__ b_out, T* __restrict__ out, int n, int d, int f,
                 int act, float eps) {
  extern __shared__ float smem[];
  float* hs = smem;                           // d x kLd: normalised rows, K-major
  float* hid = hs + (size_t)d * kLd;          // kTile x kLd: hidden tile, K-major
  float* ws = hid + kTile * kLd;              // kSlab x kTile: staged weight slab
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long row0 = (long long)blockIdx.x * kRows;

  for (int i = 0; i < kRows / 8; ++i) {
    const int r = warp * (kRows / 8) + i;
    const long long row = row0 + r;
    if (row < n) {
      const T* xr = x + row * d;
      const float2 st = ln_stats(xr, d, eps, lane);
      for (int c = lane; c < d; c += 32)
        hs[c * kLd + r] = (to_f32(xr[c]) - st.x) * st.y * ln_scale[c] + ln_bias[c];
    } else {
      for (int c = lane; c < d; c += 32) hs[c * kLd + r] = 0.f;
    }
  }

  float acc[NCH][4][8];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[ch][i][j] = 0.f;
  __syncthreads();

  for (int f0 = 0; f0 < f; f0 += kTile) {
    // hidden tile (32, 256) = h (32, d) . W_in[:, f0 : f0 + 256]
    float hacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) hacc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kSlab) {
      for (int e = tid; e < kSlab * kTile; e += kThreads) {
        const int k = k0 + e / kTile, col = f0 + e % kTile;
        ws[e] = (k < d && col < f) ? w_in[(size_t)k * f + col] : 0.f;
      }
      __syncthreads();
      const int kn = min(kSlab, d - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&hs[(k0 + kk) * kLd + 4 * warp]);
        float b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ws[kk * kTile + lane + 32 * j];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          hacc[0][j] += a.x * b[j];
          hacc[1][j] += a.y * b[j];
          hacc[2][j] += a.z * b[j];
          hacc[3][j] += a.w * b[j];
        }
      }
      __syncthreads();
    }
    // bias and activation; the tile goes to shared memory K-major
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + lane + 32 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < f) {
        const float bb = b_in[col];
        v.x = activate(hacc[0][j] + bb, act);
        v.y = activate(hacc[1][j] + bb, act);
        v.z = activate(hacc[2][j] + bb, act);
        v.w = activate(hacc[3][j] + bb, act);
      }
      *reinterpret_cast<float4*>(&hid[(lane + 32 * j) * kLd + 4 * warp]) = v;
    }
    __syncthreads();

    // out (32, d) += mid (32, 256) . W_out[f0 : f0 + 256, :]
    const int kt = min(kTile, f - f0);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int c0 = ch * kTile;
      for (int k0 = 0; k0 < kt; k0 += kSlab) {
        for (int e = tid; e < kSlab * kTile; e += kThreads) {
          const int kk = e / kTile, col = c0 + e % kTile;
          ws[e] = (k0 + kk < kt && col < d) ? w_out[(size_t)(f0 + k0 + kk) * d + col] : 0.f;
        }
        __syncthreads();
        const int kn = min(kSlab, kt - k0);
        for (int kk = 0; kk < kn; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&hid[(k0 + kk) * kLd + 4 * warp]);
          float b[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = ws[kk * kTile + lane + 32 * j];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[ch][0][j] += a.x * b[j];
            acc[ch][1][j] += a.y * b[j];
            acc[ch][2][j] += a.z * b[j];
            acc[ch][3][j] += a.w * b[j];
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + 4 * warp + i;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = ch * kTile + lane + 32 * j;
        if (col < d) out[row * d + col] = from_f32<T>(acc[ch][i][j] + b_out[col]);
      }
    }
}

template <typename T, int NCH>
cudaError_t launch_fma(const void* x, const void* ln_scale, const void* ln_bias, const void* w_in,
                       const void* b_in, const void* w_out, const void* b_out, void* out, int n,
                       int d, int f, int act, float eps, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(ffn_fused_kernel<T, NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  ffn_fused_kernel<T, NCH><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(w_out),
      static_cast<const float*>(b_out), static_cast<T*>(out), n, d, f, act, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w_in, const void* b_in, const void* w_out, const void* b_out,
                         void* out, int n, int d, int f, int act, float eps, cudaStream_t stream) {
  switch ((d + kTile - 1) / kTile) {
    case 1:
      return launch_fma<T, 1>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act,
                              eps, stream);
    case 2:
      return launch_fma<T, 2>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act,
                              eps, stream);
    case 3:
      return launch_fma<T, 3>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act,
                              eps, stream);
    case kMaxChunks:
      return launch_fma<T, kMaxChunks>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d,
                                       f, act, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* ln_scale, const void* ln_bias, const void* w_in,
                     const void* b_in, const void* w_out, const void* b_out, void* out,
                     void* scratch, int n, int d, int f, int dp, int fp, int act, int rows,
                     float eps, cudaStream_t s) {
  if (rows == 0)
    return dispatch_fma<T>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act,
                           eps, s);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return launch_mma<T>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, scratch, n, d, f, dp,
                       fp, rows, act, eps, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x, out: (n, d); ln_scale,
// ln_bias, b_out: (d,); w_in: (d, f); b_in: (f,); w_out: (f, d); weights and
// biases f32, all contiguous.  d in [1, 1024].  rows: the route, 0 =
// multiply in f32 (the FMA kernel), 16, 32 or 64 = multiply in bf16 on
// tensor cores with that many rows a block; scratch: 2 dp fp bf16 values
// for the bf16 weights, with (dp, fp) the caller's padding of (d, f): dp a
// multiple of 64 (at most 512 at 64 rows, 1024 else), fp of 128.  scratch,
// dp and fp are unused at rows 0.  Returns the launches' cudaError_t (0 on
// success).
extern "C" int rtts_ffn_fused(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* w_in, const void* b_in, const void* w_out,
                              const void* b_out, void* out, void* scratch, int dtype, int n, int d,
                              int f, int dp, int fp, int act, int rows, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaSuccess;
  if (d < 1 || d > kMaxChunks * kTile || f < 1 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, scratch, n,
                                d, f, dp, fp, act, rows, eps, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out,
                                        scratch, n, d, f, dp, fp, act, rows, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core kernel's resources at rows a block (16, 32, 64) and
// padded width dp (as rtts_ffn_fused takes it), x in bf16: out[0..3]
// (kernel_resources).  Returns the cudaError_t.
extern "C" int rtts_ffn_fused_resources(int rows, int dp, int* out) {
  if (!tile_takes(rows, dp)) return (int)cudaErrorInvalidValue;
  return (int)kernel_resources(mma_kernel<__nv_bfloat16>(rows), kMmaThreads,
                               mma_smem_bytes(rows, dp), out);
}
