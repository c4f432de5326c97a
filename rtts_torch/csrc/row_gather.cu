// Row gather out[i] = x[idx[i]] for Hopper, sm_90a (kernel K8).
//
// Replaces the TPU kernel scripts/probe_vmem_sort.py::_row_gather_kernel
// (launched by vmem_row_gather): a loop over rows with the indices in
// SMEM and x resident in VMEM.  Same contract: x (rows, d) in f32 or bf16,
// idx int32 with 0 <= idx < rows; here idx may have any length m and out
// is (m, d).  An index out of range stops the kernel (a trap, reported at
// the next synchronize), as a device-side index check would.
//
// What bounds it on this card: bytes (the rows read, idx read, out
// written; no arithmetic).  Design: the copy is of bytes, in vectors of
// VB = 16, 8, 4 or 2 bytes (the widest that divides a row and the
// pointers' alignment; 16 wherever d * itemsize % 16 == 0).  A group of
// G lanes (a power of two up to 32, the fewest covering a row's vectors)
// copies one row, so a warp reads whole 16-byte vectors of one or more
// contiguous rows: a 256-byte bf16 row of 128 values takes 16 lanes, a
// warp two rows.  Every lane of a group reads the row's index (one
// broadcast load).  The TPU's resident-VMEM loop is not carried over:
// there is no fast memory that holds a whole (rows, d) operand here, and
// L2 serves the reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const V* __restrict__ x, const int* __restrict__ idx, V* __restrict__ out,
                      long long m, int rows, int vecs, int group_log2) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t >> group_log2;
  if (row >= m) return;
  const int group = 1 << group_log2;
  const int lane = (int)(t & (group - 1));
  const int k = __ldg(idx + row);
  if ((unsigned)k >= (unsigned)rows) __trap();
  const V* src = x + (long long)k * vecs;
  V* dst = out + row * vecs;
  for (int v = lane; v < vecs; v += group) dst[v] = __ldg(src + v);
}

template <typename V>
cudaError_t launch(const void* x, const void* idx, void* out, int m, int rows, int row_bytes,
                   cudaStream_t stream) {
  const int vecs = row_bytes / (int)sizeof(V);
  int group_log2 = 0;
  while ((1 << group_log2) < vecs && group_log2 < 5) ++group_log2;
  const long long threads = (long long)m << group_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  row_gather_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<const int*>(idx), static_cast<V*>(out), m, rows,
      vecs, group_log2);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, row_bytes) bytes, idx: (m,) int32, out: (m, row_bytes) bytes,
// all contiguous; vec_bytes (16, 8, 4 or 2) divides row_bytes and the
// alignment of x and out.  Returns the launch's cudaError_t.
extern "C" int rtts_row_gather(const void* x, const void* idx, void* out, int m, int rows,
                               int row_bytes, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 0 || rows < 0 || row_bytes < 0 || vec_bytes < 2 || row_bytes % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || row_bytes == 0) return (int)cudaSuccess;
  switch (vec_bytes) {
    case 16: return (int)launch<uint4>(x, idx, out, m, rows, row_bytes, s);
    case 8: return (int)launch<uint2>(x, idx, out, m, rows, row_bytes, s);
    case 4: return (int)launch<uint32_t>(x, idx, out, m, rows, row_bytes, s);
    case 2: return (int)launch<uint16_t>(x, idx, out, m, rows, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
