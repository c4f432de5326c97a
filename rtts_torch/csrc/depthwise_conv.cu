// Depthwise 1-D convolution for Hopper, sm_90a: the SqueezeWave WN depth stage.
//
// Replaces the TPU kernel rtts/ops/depthwise_conv.py::_dw_kernel (launched by
// _dw_pallas_raw, wrapped by depthwise_conv1d_pallas).  Same contract:
// x (B, L, C) channels-last, w (K, 1, C), b (C,); SAME zero padding reaching
// (K-1)//2 to the left and K//2 to the right (XLA's rule, which differs from
// a symmetric pad for even K); f32 accumulation, bias added in f32, output
// cast to x's dtype.  w and b may be float32 while x is bfloat16 (the
// vocoder's folded parameters): each is rounded to x's dtype in registers,
// which is what casting them first would give, so no cast kernel runs.
//
// What bounds it on this card: K multiply-adds per element against one
// read and one write of x.  At the vocoder's shapes ((1..8, 1024, 128)
// bf16, 0.26-2 MB) the bytes take about a microsecond, so the launch and
// the host path around it set the time.  Design: one block per (row tile,
// batch item) covering every channel.  The tile is kRows rows, halved (to
// kMinRows at least) while the blocks would not cover the card's SMs: the
// serving path's batch of one at L 1024 gets 4-row tiles, 256 blocks, where
// 32-row tiles gave 32 blocks for 132 SMs.  Each block stages the tile and its
// (K-1)-row halo in shared memory with 16-byte vector loads (zeros outside
// the sequence: the SAME padding), so each x element is read from HBM once
// (the halo rows twice, from L2).  Thread (cv, ty) owns the channel vector
// cv and walks the tile's rows ty, ty + blockDim.y, ...; its K weights and
// bias stay in registers.  Channels that are not a multiple of the vector
// width, or x and out not 16-byte aligned, take the scalar (VEC 1)
// instantiation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;        // output rows per block, most
constexpr int kMinRows = 4;      // and least (the halo is K - 1 rows)
constexpr int kMaxTaps = 8;      // taps the register arrays hold
constexpr int kThreads = 256;
constexpr int kSmemBytes = 40960;  // staging budget per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a parameter rounded to x's dtype T, then widened for the f32 sum
template <typename T, typename W>
__device__ __forceinline__ float as_x_dtype(W v) {
  return to_f32(from_f32<T>(to_f32(v)));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kThreads)
depthwise_conv_kernel(const T* __restrict__ x, const W* __restrict__ w,
                      const W* __restrict__ bias, T* __restrict__ out, int len, int channels,
                      int taps, int rows) {
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* tile = reinterpret_cast<V*>(smem_raw);  // (rows + taps - 1) x nvec

  const int nvec = channels / VEC;
  const int t0 = blockIdx.x * rows;
  const int left = (taps - 1) / 2;
  const T* xb = x + (size_t)blockIdx.y * len * channels;
  T* ob = out + (size_t)blockIdx.y * len * channels;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int staged = (rows + taps - 1) * nvec;
  V zero;
#pragma unroll
  for (int i = 0; i < VEC; ++i) zero.v[i] = from_f32<T>(0.f);
  for (int i = tid; i < staged; i += nthreads) {
    const int r = i / nvec, cv = i - r * nvec, tt = t0 - left + r;
    tile[i] = (tt >= 0 && tt < len)
                  ? *reinterpret_cast<const V*>(xb + (size_t)tt * channels + cv * VEC)
                  : zero;
  }
  __syncthreads();

  const int n_rows = min(rows, len - t0);
  for (int cv = threadIdx.x; cv < nvec; cv += blockDim.x) {
    float wr[kMaxTaps][VEC], br[VEC];
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        wr[k][i] = k < taps ? as_x_dtype<T>(w[(size_t)k * channels + cv * VEC + i]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) br[i] = as_x_dtype<T>(bias[cv * VEC + i]);
    for (int r = threadIdx.y; r < n_rows; r += blockDim.y) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxTaps; ++k) {
        if (k < taps) {
          const V xv = tile[(r + k) * nvec + cv];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += to_f32(xv.v[i]) * wr[k][i];
        }
      }
      V o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i] + br[i]);
      *reinterpret_cast<V*>(ob + (size_t)(t0 + r) * channels + cv * VEC) = o;
    }
  }
}

// the current card's SM count, read at the first launch (the port runs
// on one kind of card at a time)
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      sms = n;
  }
  return sms;
}

template <typename T, typename W, int VEC>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int batch, int len,
                   int channels, int taps, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  int rows = min(kRows, kSmemBytes / (channels * es) - (taps - 1));
  if (rows < 1 || taps < 1 || taps > kMaxTaps) return cudaErrorInvalidValue;
  const int sms = sm_count();
  while (rows > kMinRows && (long long)batch * ((len + rows - 1) / rows) < sms) rows /= 2;
  const int nvec = channels / VEC;
  const int tx = min(nvec, kThreads);
  const dim3 block(tx, max(1, min(kThreads / tx, rows)));
  const dim3 grid((len + rows - 1) / rows, batch);
  const size_t smem = (size_t)(rows + taps - 1) * channels * es;
  depthwise_conv_kernel<T, W, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
      static_cast<T*>(out), len, channels, taps, rows);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t dispatch_vec(const void* x, const void* w, const void* b, void* out, int batch,
                         int len, int channels, int taps, int vec, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
                        16) == 0;
  if (vec == kVec && aligned)
    return launch<T, W, kVec>(x, w, b, out, batch, len, channels, taps, s);
  if (vec == kVec || vec == 1) return launch<T, W, 1>(x, w, b, out, batch, len, channels, taps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dims: the launch's host-side description, {x dtype, w dtype, batch, len,
// channels, taps, vec}: dtypes 0 = float32, 1 = bfloat16 (w's is that of w
// and b); vec the channels per thread, 1 or 16 bytes of x when channels
// allows (the 16-byte path also needs x and out 16-byte aligned, else it
// takes vec 1).  x, out: (batch, len, channels) contiguous; w: (taps, 1,
// channels) contiguous; b: (channels,).  One pointer instead of seven
// integers keeps the caller's per-call argument conversion short.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for taps outside 1..8
// or rows too wide for the staging buffer).
extern "C" int rtts_depthwise_conv1d(const int* dims, const void* x, const void* w,
                                     const void* b, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int x_dtype = dims[0], w_dtype = dims[1], batch = dims[2], len = dims[3],
            channels = dims[4], taps = dims[5], vec = dims[6];
  if ((long long)batch * len * channels == 0) return (int)cudaSuccess;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)dispatch_vec<float, float>(x, w, b, out, batch, len, channels, taps, vec, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)dispatch_vec<float, __nv_bfloat16>(x, w, b, out, batch, len, channels, taps,
                                                   vec, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)dispatch_vec<__nv_bfloat16, float>(x, w, b, out, batch, len, channels, taps,
                                                   vec, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)dispatch_vec<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, batch, len, channels,
                                                           taps, vec, s);
  return (int)cudaErrorInvalidValue;
}
