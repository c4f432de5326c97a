// Column-wise bitonic sort of int32 keys for Hopper, sm_90a (kernel K7).
//
// Replaces the TPU kernel scripts/probe_vmem_sort.py::_bitonic_kernel
// (launched by bitonic_sort_cols).  Same contract: x (n, C) int32,
// row-major, n a power of two; each column sorted ascending as signed
// integers.  With packed keys bucket * L + pos a value sort is the stable
// bucket sort and key % L the permutation.  The compare-exchange network
// is the TPU kernel's (stage k = 2 .. n, partner distance j = k/2 .. 1,
// ascending where bit k of the lower index is clear), so the kernel and
// its plain version move the same values to the same places.
//
// What bounds it on this card: bytes, by the table's rates (each key read
// once and written once; the n/2 log2(n) (log2(n)+1)/2 compare-exchanges
// per column are two integer operations each, far below the bytes' time).
// In practice it is bound by its log2(n) (log2(n)+1)/2 dependent passes,
// each ended by a block barrier.
//
// Design: one block sorts TC adjacent columns whole in shared memory, at
// most 1024 threads, each doing compare-exchanges of one pass in a loop.
// Shared memory holds the tile column-major with a stride of n + 1 words:
// a pass's partners i and i + j of one column are words of neighbouring
// threads (no bank conflicts), and the padding spreads the load's TC
// columns of one row over TC banks.  The load reads each row's TC keys as
// one segment, so wider tiles coalesce; the wrapper picks TC (1, 2, 4 or
// 8) as the widest that still gives every SM a block, because the passes,
// not the bytes, take the time.  The TPU's 128-lane block with rolls is
// not carried over.  n up to 32768 (128 KB a column, above the 48 KB
// default: the dynamic shared memory opt-in); the wrapper raises beyond.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

template <int TC>
__global__ void __launch_bounds__(kMaxThreads)
    bitonic_cols_kernel(const int* __restrict__ x, int* __restrict__ out, int n, int log_n,
                        int cols) {
  extern __shared__ int s[];  // TC columns of n keys, stride n + 1
  const int stride = n + 1;
  const int c0 = blockIdx.x * TC;
  const int total = n * TC;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / TC, cc = e % TC;
    s[cc * stride + r] = x[(long long)r * cols + c0 + cc];
  }
  __syncthreads();
  const int half = n >> 1;  // compare-exchanges per column and pass
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half * TC; p += blockDim.x) {
        const int cc = p >> (log_n - 1);
        const int q = p & (half - 1);
        // the lower index of pair q: q with a zero bit inserted at j
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        int* col = s + cc * stride;
        const int a = col[i], b = col[i + j];
        if ((a > b) == ((i & k) == 0)) {
          col[i] = b;
          col[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / TC, cc = e % TC;
    out[(long long)r * cols + c0 + cc] = s[cc * stride + r];
  }
}

template <int TC>
cudaError_t launch(const int* x, int* out, int n, int cols, cudaStream_t stream) {
  const size_t smem = (size_t)(n + 1) * TC * sizeof(int);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bitonic_cols_kernel<TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  int threads = (n >> 1) * TC;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  bitonic_cols_kernel<TC><<<(unsigned)(cols / TC), threads, smem, stream>>>(x, out, n, log_n,
                                                                            cols);
  return cudaGetLastError();
}

}  // namespace

// x, out: (n, cols) int32, row-major, contiguous; n a power of two;
// tc: adjacent columns per block (1, 2, 4 or 8), dividing cols.  Returns
// the launch's cudaError_t.
extern "C" int rtts_bitonic_sort_cols(const void* x, void* out, int n, int cols, int tc,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (n & (n - 1)) != 0 || cols < 0 || tc < 1 || cols % tc != 0)
    return (int)cudaErrorInvalidValue;
  if (cols == 0) return (int)cudaSuccess;
  const int* xi = static_cast<const int*>(x);
  int* oi = static_cast<int*>(out);
  switch (tc) {
    case 1: return (int)launch<1>(xi, oi, n, cols, s);
    case 2: return (int)launch<2>(xi, oi, n, cols, s);
    case 4: return (int)launch<4>(xi, oi, n, cols, s);
    case 8: return (int)launch<8>(xi, oi, n, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
