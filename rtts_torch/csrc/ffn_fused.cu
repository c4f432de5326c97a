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
// round() casts to the multiply dtype (bf16 or f32, `bf16` below): the
// products of two bf16 values are exact in f32, so FMAs on the rounded
// values give the tensor cores' bf16 x bf16 -> f32 arithmetic up to the
// order of the sums.  Weights and biases are f32; out has x's dtype.
// act: 0 relu, 1 tanh-GELU, 2 tanh, 3 silu.
//
// What bounds it on this card: 4 n d f operations against ~4 (2 n d + 2 d f)
// bytes, so at the decoder's 8192 rows x 512 -> 2048 it is bound by the
// operations (34 GFLOP).  Design: one block of 256 threads per 32 rows.
// The block normalises its rows into shared memory (K-major, already
// rounded), then walks d_ff in tiles of 256: the (32, 256) hidden tile is
// computed from weight slabs of 16 rows staged through shared memory, gets
// its bias and activation, is rounded and kept in shared memory, and is at
// once multiplied into the (32, d) output, which stays in registers (each
// thread 4 rows x 8 columns per 256 output columns).  The (n, d_ff)
// intermediate never reaches device memory, which is what the TPU kernel
// exists for.  The weights cannot stay resident as in the TPU's VMEM (4 MB
// in bf16 at 512 x 2048); every block streams them from L2.  The products
// are f32 FMAs; tensor cores (mma / wgmma) and TMA are later work.  Widths
// up to 1024; any row count and any d_ff.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;       // rows of x per block
constexpr int kThreads = 256;   // 8 warps; warp w owns rows 4w..4w+3
constexpr int kTile = 256;      // hidden columns per d_ff tile = output columns per chunk
constexpr int kSlab = 16;       // weight rows staged per step
constexpr int kLd = kRows + 4;  // stride of the K-major tiles: float4-aligned rows
constexpr int kMaxChunks = 4;   // output chunks of 256: d <= 1024

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float round_mxu(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
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

size_t smem_bytes(int d) {
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
                 int act, int bf16, float eps) {
  extern __shared__ float smem[];
  float* hs = smem;                           // d x kLd: normalised rows, K-major
  float* hid = hs + (size_t)d * kLd;          // kTile x kLd: hidden tile, K-major
  float* ws = hid + kTile * kLd;              // kSlab x kTile: staged weight slab
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long row0 = (long long)blockIdx.x * kRows;

  // LayerNorm, two passes over the row as the TPU kernel: mean, then the
  // mean of the squared deviations
  for (int i = 0; i < kRows / 8; ++i) {
    const int r = warp * (kRows / 8) + i;
    const long long row = row0 + r;
    if (row < n) {
      const T* xr = x + row * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float t = to_f32(xr[c]) - mean;
        v += t * t;
      }
      const float rstd = 1.f / sqrtf(warp_sum(v) / d + eps);
      for (int c = lane; c < d; c += 32)
        hs[c * kLd + r] = round_mxu((to_f32(xr[c]) - mean) * rstd * ln_scale[c] + ln_bias[c], bf16);
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
        ws[e] = (k < d && col < f) ? round_mxu(w_in[(size_t)k * f + col], bf16) : 0.f;
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
    // bias, activation, rounding; the tile goes to shared memory K-major
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + lane + 32 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < f) {
        const float bb = b_in[col];
        v.x = round_mxu(activate(hacc[0][j] + bb, act), bf16);
        v.y = round_mxu(activate(hacc[1][j] + bb, act), bf16);
        v.z = round_mxu(activate(hacc[2][j] + bb, act), bf16);
        v.w = round_mxu(activate(hacc[3][j] + bb, act), bf16);
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
          ws[e] = (k0 + kk < kt && col < d)
                      ? round_mxu(w_out[(size_t)(f0 + k0 + kk) * d + col], bf16)
                      : 0.f;
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
cudaError_t launch(const void* x, const void* ln_scale, const void* ln_bias, const void* w_in,
                   const void* b_in, const void* w_out, const void* b_out, void* out, int n, int d,
                   int f, int act, int bf16, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(ffn_fused_kernel<T, NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  ffn_fused_kernel<T, NCH><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(w_out),
      static_cast<const float*>(b_out), static_cast<T*>(out), n, d, f, act, bf16, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* ln_scale, const void* ln_bias, const void* w_in,
                     const void* b_in, const void* w_out, const void* b_out, void* out, int n,
                     int d, int f, int act, int bf16, float eps, cudaStream_t stream) {
  switch ((d + kTile - 1) / kTile) {
    case 1:
      return launch<T, 1>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act, bf16,
                          eps, stream);
    case 2:
      return launch<T, 2>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act, bf16,
                          eps, stream);
    case 3:
      return launch<T, 3>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act, bf16,
                          eps, stream);
    case kMaxChunks:
      return launch<T, kMaxChunks>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f,
                                   act, bf16, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x, out: (n, d); ln_scale,
// ln_bias, b_out: (d,); w_in: (d, f); b_in: (f,); w_out: (f, d); weights and
// biases f32, all contiguous.  d in [1, 1024]; bf16: multiply in bf16.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rtts_ffn_fused(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* w_in, const void* b_in, const void* w_out,
                              const void* b_out, void* out, int dtype, int n, int d, int f,
                              int act, int bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaSuccess;
  if (d < 1 || d > kMaxChunks * kTile || f < 1 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d, f, act,
                                bf16, eps, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, out, n, d,
                                        f, act, bf16, eps, s);
  return (int)cudaErrorInvalidValue;
}
