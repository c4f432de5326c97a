// Bitonic sort of int32 keys along rows for Hopper, sm_90a (kernel K7),
// behind two loaders.
//
// Replaces the TPU kernel scripts/probe_vmem_sort.py::_bitonic_kernel
// (launched by bitonic_sort_cols), which sorts the packed LSH keys
// bucket * L + pos in fast memory.  The compare-exchange network is the
// TPU kernel's (stage k = 2 .. P, partner distance j = k/2 .. 1, ascending
// where bit k of the lower index is clear), so both move the same values.
// Two entries share the sort body:
//
// - rtts_sort_by_bucket, the LSH path's whole bucket sort
//   (rtts_torch/attention/lsh.py::_sort_by_bucket): per row of L int64
//   buckets it builds key = bucket * L + pos in int32 on the load, pads
//   the row to the next power of two P with INT32_MAX (after every real
//   key: the caller keeps (buckets + 1) * L < 2^31), sorts, and writes
//   sorted_pos = key % L and sorted_buckets = key / L at slots s < L and
//   undo_idx[key % L] = s, all int64.  The keys are unique, so this is the
//   stable sort, bit for bit.  undo is a permutation within the row: it is
//   staged in shared memory (each position written once, no atomics) and
//   written coalesced;
// - rtts_bitonic_sort_cols, the TPU kernel's contract: each column of an
//   (n, C) int32 array sorted ascending, n a power of two.
//
// What bounds it on this card: bytes, by the table's rates (the path entry
// reads 8 B and writes 24 B a key; its compare-exchanges are two integer
// operations each, far below the bytes' time).  What holds a bitonic sort
// back is its chain of log2(P) (log2(P) + 1) / 2 dependent passes, so the
// design keeps the passes off shared memory and barriers:
//
// - each thread holds E adjacent keys of a row in registers (E = 8, or
//   P / 1024 past 8192 keys a block), loaded with 16-byte vectors where
//   the row allows.  Passes with j < E run in a thread's registers, fully
//   unrolled; passes with E <= j < 32 E across lanes with
//   __shfl_xor_sync; only passes with j >= 32 E go through shared memory,
//   each ended by a block barrier (at P 8192: 15 of 91 passes).  Masks,
//   partners and directions come from shifts: P is a power of two;
// - a row of P <= 32 E keys lives in one warp (several rows a warp below
//   that), with no block barrier at all; a block takes several rows where
//   that still gives every SM a block;
// - where the rows would leave SMs idle (64 rows of 8192 on 132 SMs), a
//   row spans a 2-CTA thread-block cluster: each CTA sorts its half, the
//   two halves in opposite directions as the network has them, and only
//   the pass j = P / 2 reads the partner CTA's shared memory (distributed
//   shared memory); the undo staging writes across the pair the same way.
//   The route (rtts_torch/ops/bitonic_sort.py::sort_route) picks the
//   cluster and the rows a block.
//
// P up to 32768 (a one-CTA row holds 128 KB of keys in shared memory for
// its wide passes, above the 48 KB default: the dynamic opt-in).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kPad = 0x7fffffff;  // sorts after every real key
constexpr int kMaxKeys = 32768;

__device__ __forceinline__ void cmp_swap(int& a, int& b, bool up) {
  const int lo = min(a, b), hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// One CTA's part of a sort row: n = 2^log_n keys of the row's P, the slots
// rank * n .. (rank + 1) * n - 1; thread t holds slots base .. base + E - 1,
// base = rank * n + t * E.  buf: the part's n ints of shared memory.
struct Part {
  int log_p, log_n, t, rank, base;
  int* buf;
};

template <int E>
__device__ __forceinline__ void store_own(int* dst, const int (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4)
    *reinterpret_cast<int4*>(dst + i) = make_int4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

template <int E>
__device__ __forceinline__ void load_own(int (&x)[E], const int* src) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const int4 v = *reinterpret_cast<const int4*>(src + i);
    x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
  }
}

template <int CL>
__device__ __forceinline__ void sync_row() {
  if constexpr (CL > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// The pass j >= n: partner slots in CTA rank ^ (j / n) of the cluster.
template <int E>
__device__ void cross_pass(int (&x)[E], const Part& p, int j, int k) {
  cg::cluster_group cluster = cg::this_cluster();
  store_own<E>(p.buf + p.t * E, x);
  cluster.sync();
  const int d = j >> p.log_n;
  const int* other = cluster.map_shared_rank(p.buf, p.rank ^ d);
  int o[E];
  load_own<E>(o, other + p.t * E);
  const bool keep_min = ((p.rank & d) == 0) == ((p.base & k) == 0);
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = keep_min ? min(x[e], o[e]) : max(x[e], o[e]);
  cluster.sync();  // the partner has read this CTA's keys
}

// Sort the row's P keys ascending; on return thread t holds slots
// base .. base + E - 1 of the sorted row.  Every thread of the block (of
// the cluster) runs it, rows past the end too: the barriers and shuffles
// take them all.
template <int E, int CL>
__device__ void bitonic_body(int (&x)[E], const Part& p) {
  constexpr int kWarpKeys = 32 * E;
  constexpr int kLogE = E == 8 ? 3 : (E == 16 ? 4 : 5);
  const int n = 1 << p.log_n;
  const int threads = n >> kLogE;
  const int part0 = p.rank << p.log_n;
  for (int k = 2; k <= (1 << p.log_p); k <<= 1) {
    int j = k >> 1;
    if constexpr (CL > 1) {
      for (; j >= n; j >>= 1) cross_pass<E>(x, p, j, k);
    }
    if (j >= kWarpKeys) {
      store_own<E>(p.buf + p.t * E, x);
      __syncthreads();
      for (; j >= kWarpKeys; j >>= 1) {
#pragma unroll
        for (int m = 0; m < E / 2; ++m) {
          const int q = p.t + m * threads;
          // the lower slot of pair q: q with a zero bit inserted at j
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          int a = p.buf[i], b = p.buf[i + j];
          cmp_swap(a, b, ((part0 + i) & k) == 0);
          p.buf[i] = a;
          p.buf[i + j] = b;
        }
        __syncthreads();
      }
      load_own<E>(x, p.buf + p.t * E);
    }
    for (; j >= E; j >>= 1) {
      const int m = j >> kLogE;  // the partner lane's distance
      const bool keep_min = ((p.t & m) == 0) == ((p.base & k) == 0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int o = __shfl_xor_sync(0xffffffffu, x[e], m);
        x[e] = keep_min ? min(x[e], o) : max(x[e], o);
      }
    }
#pragma unroll
    for (int jj = E / 2; jj >= 1; jj >>= 1) {
      if (jj < k) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if ((e & jj) == 0) cmp_swap(x[e], x[e | jj], ((p.base | e) & k) == 0);
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// The LSH path's bucket sort: rows of L int64 buckets.
struct BucketIO {
  const long long* buckets;
  long long *sorted_pos, *undo, *sorted_buckets;
  int l, log_l;  // log_l: log2(L) where L is a power of two, else -1

  template <int E>
  __device__ void load(int (&x)[E], int row, int base) const {
    const long long* src = buckets + (long long)row * l;
    if (row >= 0 && base + E <= l && aligned16(src + base)) {
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        const longlong2 v = *reinterpret_cast<const longlong2*>(src + base + e);
        x[e] = (int)v.x, x[e + 1] = (int)v.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = (row >= 0 && base + e < l) ? (int)src[base + e] : 0;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = (row >= 0 && base + e < l) ? x[e] * l + base + e : kPad;
  }

  __device__ __forceinline__ void split(int key, int& bucket, int& pos) const {
    if (log_l >= 0) {
      bucket = key >> log_l;
      pos = key & (l - 1);
    } else {
      bucket = (int)((unsigned)key / (unsigned)l);
      pos = key - bucket * l;
    }
  }

  template <int E, int CL>
  __device__ void finish(int (&x)[E], const Part& p, int row) const {
    const long long off = (long long)row * l + p.base;
    const int count = row < 0 ? 0 : max(0, min(E, l - p.base));
    const bool vec = count == E && aligned16(sorted_pos + off) &&
                     aligned16(sorted_buckets + off);
    // sorted_pos and sorted_buckets from registers; x keeps the positions
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      int b0, p0, b1, p1;
      split(x[e], b0, p0);
      split(x[e + 1], b1, p1);
      if (vec) {
        *reinterpret_cast<longlong2*>(sorted_pos + off + e) = make_longlong2(p0, p1);
        *reinterpret_cast<longlong2*>(sorted_buckets + off + e) = make_longlong2(b0, b1);
      } else {
        if (e < count) sorted_pos[off + e] = p0, sorted_buckets[off + e] = b0;
        if (e + 1 < count) sorted_pos[off + e + 1] = p1, sorted_buckets[off + e + 1] = b1;
      }
      x[e] = p0, x[e + 1] = p1;
    }
    // undo_idx[pos] = slot, staged in the shared memory of the CTA that
    // holds slot pos, then written coalesced
    const int mask = (1 << p.log_n) - 1;
    sync_row<CL>();  // every part has read its keys out of buf
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < count) {
        int* dst = p.buf;
        if constexpr (CL > 1) dst = cg::this_cluster().map_shared_rank(p.buf, x[e] >> p.log_n);
        dst[x[e] & mask] = p.base + e;
      }
    }
    sync_row<CL>();
    if (row < 0) return;
    const int part0 = p.rank << p.log_n;
    const int threads = (mask + 1) / E;
    for (int i = p.t; i <= mask && part0 + i < l; i += threads)
      undo[(long long)row * l + part0 + i] = p.buf[i];
  }
};

// The TPU kernel's contract: column ``row`` of an (n, cols) row-major
// array is a sort row; P = max(n, 8), the slots past n padded.
struct ColumnIO {
  const int* x;
  int* out;
  int n, cols;

  template <int E>
  __device__ void load(int (&v)[E], int row, int base) const {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = (row >= 0 && base + e < n) ? x[(long long)(base + e) * cols + row] : kPad;
  }

  template <int E, int CL>
  __device__ void finish(int (&v)[E], const Part& p, int row) const {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (row >= 0 && p.base + e < n) out[(long long)(p.base + e) * cols + row] = v[e];
  }
};

template <int E, int CL, class IO>
__global__ void __launch_bounds__(kMaxThreads)
    bitonic_rows_kernel(IO io, int log_p, int log_n, int rows, int rows_per_block) {
  extern __shared__ int4 smem_vec[];
  constexpr int kLogE = E == 8 ? 3 : (E == 16 ? 4 : 5);
  const int log_t = log_n - kLogE;
  const int rr = threadIdx.x >> log_t;
  Part p;
  p.log_p = log_p;
  p.log_n = log_n;
  p.t = threadIdx.x & ((1 << log_t) - 1);
  p.rank = 0;
  if constexpr (CL > 1) p.rank = (int)cg::this_cluster().block_rank();
  p.base = (p.rank << log_n) + p.t * E;
  p.buf = reinterpret_cast<int*>(smem_vec) + (rr << log_n);
  int row = (int)(blockIdx.x / CL) * rows_per_block + rr;
  if (row >= rows) row = -1;
  int x[E];
  io.template load<E>(x, row, p.base);
  bitonic_body<E, CL>(x, p);
  io.template finish<E, CL>(x, p, row);
}

template <int E, int CL, class IO>
cudaError_t launch(const IO& io, int log_p, int rows, int rows_per_block,
                   cudaStream_t stream) {
  constexpr int kLogE = E == 8 ? 3 : (E == 16 ? 4 : 5);
  const int log_n = log_p - (CL > 1 ? 1 : 0);
  const long long threads = (long long)rows_per_block << (log_n - kLogE);
  const long long smem = ((long long)rows_per_block << log_n) * (long long)sizeof(int);
  if (rows_per_block < 1 || threads > kMaxThreads || threads % 32 != 0 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto kernel = bitonic_rows_kernel<E, CL, IO>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + rows_per_block - 1) / rows_per_block * CL));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, io, log_p, log_n, rows, rows_per_block);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// E = max(8, keys a CTA / 1024): at most 1024 threads a row part.
template <int CL, class IO>
cudaError_t dispatch(const IO& io, int log_p, int rows, int rows_per_block, cudaStream_t s) {
  const int n = (1 << log_p) / CL;
  if (n <= 8192) return launch<8, CL>(io, log_p, rows, rows_per_block, s);
  if (n == 16384) return launch<16, CL>(io, log_p, rows, rows_per_block, s);
  if constexpr (CL == 1) {
    if (n == 32768) return launch<32, CL>(io, log_p, rows, rows_per_block, s);
  }
  return cudaErrorInvalidValue;
}

int ceil_log2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

}  // namespace

// buckets: (rows, l) int64 contiguous, each row's (bucket + 1) * l
// < 2^31; sorted_pos, undo_idx, sorted_buckets: (rows, l) int64
// contiguous.  cluster: CTAs a row (1 or
// 2); rows_per_block: rows a block (a cluster), whose threads must make
// whole warps, at most 1024.  Returns the launch's cudaError_t.
extern "C" int rtts_sort_by_bucket(const void* buckets, void* sorted_pos, void* undo_idx,
                                   void* sorted_buckets, int rows, int l, int cluster,
                                   int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l < 1 || l > kMaxKeys || rows < 0 || (cluster != 1 && cluster != 2))
    return (int)cudaErrorInvalidValue;
  const int log_p = ceil_log2(l > 8 * cluster ? l : 8 * cluster);
  const BucketIO io{static_cast<const long long*>(buckets), static_cast<long long*>(sorted_pos),
                    static_cast<long long*>(undo_idx), static_cast<long long*>(sorted_buckets),
                    l, (l & (l - 1)) == 0 ? ceil_log2(l) : -1};
  return (int)(cluster == 2 ? dispatch<2>(io, log_p, rows, rows_per_block, s)
                            : dispatch<1>(io, log_p, rows, rows_per_block, s));
}

// x, out: (n, cols) int32, row-major, contiguous; n a power of two, at
// most 32768; tc: columns a block, whose threads (max(n, 8) / E a column)
// must make whole warps, at most 1024.  Returns the launch's cudaError_t.
extern "C" int rtts_bitonic_sort_cols(const void* x, void* out, int n, int cols, int tc,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (n & (n - 1)) != 0 || n > kMaxKeys || cols < 0 || tc < 1)
    return (int)cudaErrorInvalidValue;
  const ColumnIO io{static_cast<const int*>(x), static_cast<int*>(out), n, cols};
  return (int)dispatch<1>(io, ceil_log2(n > 8 ? n : 8), cols, tc, s);
}
