// Depthwise 1-D convolution for Hopper, sm_90a: the SqueezeWave WN depth stage.
//
// Replaces the TPU kernel rtts/ops/depthwise_conv.py::_dw_kernel (launched by
// _dw_pallas_raw, wrapped by depthwise_conv1d_pallas).  Same contract:
// x (B, L, C) channels-last, w (K, C), b (C,); SAME zero padding reaching
// (K-1)//2 to the left and K//2 to the right (XLA's rule, which differs from
// a symmetric pad for even K); f32 accumulation, bias added in f32, output
// cast to x's dtype.
//
// What bounds it on this card: K multiply-adds per element against one
// read and one write of x, so it is bound by memory traffic (and, at the
// vocoder's 2 MB tensors, by the launch).  Design: one thread per (b, t)
// and a vector of VEC neighbouring channels, so a warp reads contiguous
// 16-byte chunks of one row; the K shifted rows it needs are L1/L2 hits
// of its neighbours' reads.  Out-of-range taps are skipped, which is the
// zero padding without a padded copy.  The TPU kernel's per-batch-row
// VMEM block and roll are not needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void depthwise_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                      const T* __restrict__ bias, T* __restrict__ out,
                                      int batch, int len, int channels, int taps) {
  const int groups = channels / VEC;
  const long long n = (long long)batch * len * groups;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c0 = (int)(idx % groups) * VEC;
  const long long bt = idx / groups;
  const int t = (int)(bt % len);
  const long long row0 = bt - t;  // (b, 0) row index
  const int left = (taps - 1) / 2;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int kk = 0; kk < taps; ++kk) {
    const int tt = t + kk - left;
    if (tt < 0 || tt >= len) continue;
    const Vec<T, VEC> xv =
        *reinterpret_cast<const Vec<T, VEC>*>(x + (row0 + tt) * channels + c0);
    const Vec<T, VEC> wv = *reinterpret_cast<const Vec<T, VEC>*>(w + (long long)kk * channels + c0);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += to_f32(xv.v[i]) * to_f32(wv.v[i]);
  }
  const Vec<T, VEC> bv = *reinterpret_cast<const Vec<T, VEC>*>(bias + c0);
  Vec<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i] + to_f32(bv.v[i]));
  *reinterpret_cast<Vec<T, VEC>*>(out + bt * channels + c0) = o;
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int batch, int len,
                   int channels, int taps, cudaStream_t stream) {
  const long long n = (long long)batch * len * (channels / VEC);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  depthwise_conv_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), batch, len, channels, taps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, out: (batch, len, channels); w:
// (taps, channels); b: (channels,), all of x's dtype and contiguous.
// vec: channels per thread (1, or 16 bytes' worth when channels allows and
// the pointers are 16-byte aligned).  Returns the launch's cudaError_t.
extern "C" int rtts_depthwise_conv1d(const void* x, const void* w, const void* b, void* out,
                                     int dtype, int batch, int len, int channels, int taps,
                                     int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)batch * len * channels == 0) return (int)cudaSuccess;
  if (dtype == 0 && vec == 4)
    return (int)launch<float, 4>(x, w, b, out, batch, len, channels, taps, s);
  if (dtype == 0 && vec == 1)
    return (int)launch<float, 1>(x, w, b, out, batch, len, channels, taps, s);
  if (dtype == 1 && vec == 8)
    return (int)launch<__nv_bfloat16, 8>(x, w, b, out, batch, len, channels, taps, s);
  if (dtype == 1 && vec == 1)
    return (int)launch<__nv_bfloat16, 1>(x, w, b, out, batch, len, channels, taps, s);
  return (int)cudaErrorInvalidValue;
}
