// Per-worker message counting for Hopper (sm_90a): the (M,) tally behind
// every per_worker_* statistic of the channels (core/plan.py per_worker).
//
// It replaces no TPU kernel: the JAX package's zeros(M).at[w].add(c) is an
// XLA scatter.  It was added because torch.bincount, which computed the
// tally before, synchronises with the host twice a call (it reads min()
// and max() of its input back to size its output) and keeps its
// shared-memory bins in a way that sends every thread of a block to one
// bin when the ids arrive grouped by worker, as csr edge ids do.
//
// What it computes.  ids (n,) int32 or int64 and counts (n,) bool, int32
// or int64:
//     out[m] = sum of counts[i] over the i with ids[i] == m,  m in [0, M)
// as an int64, exact (wrapping mod 2^64 like any int64 sum).  A lane whose
// id lies outside [0, M), or whose count is 0, adds nothing.  Integer sums
// do not depend on their order, so the result is the same on every run.
//
// What bounds it.  Bytes: every id and count read once, n * (id + count
// bytes), and M * 8 written.  Hash-Min's edge flags at the lj cell's size
// are 42.85M int64 ids and bool flags, 386 MB, 0.115 ms at 3.35 TB/s.
//
// What the design does about that.  Two passes on the caller's stream, no
// host synchronisation, no global atomics and no memset:
//   1. worker_count_partial: one wave of blocks (kBlocks an SM, by its
//      launch bounds; fewer where the input is small), each over a contiguous
//      chunk of the input.  A block zeroes M 64-bit bins in shared memory.
//      Its threads walk the chunk in coalesced steps, one 16-byte load of
//      ids a thread (V = 4 int32 or 2 int64 ids) and the V counts beside
//      them, kUnroll steps in flight.  Each thread keeps a run (id, sum) in
//      registers and adds it to its shared bin only when the id changes,
//      so ids sorted by worker cost about one shared atomic a thread over
//      the whole chunk; scattered ids cost one a lane, spread over M bins.
//      The block then writes its bins to row blockIdx.x of a (blocks, M)
//      int64 scratch.
//   2. worker_count_total: one block sums the scratch over its rows, 32
//      columns at a time (a warp's lanes read 32 neighbouring columns of a
//      row, the 32 warps split the rows), into out.
// Inputs whose addresses do not allow the vector loads (a sliced view)
// take V = 1 with the same walk.
//
// Bounds.  1 <= M <= kMaxM: M 64-bit bins within the default 48 KB of
// shared memory a block.
//
// Interface: plain C functions, built with nvcc into a shared library and
// called through ctypes (repro_torch/kernels/worker_count/kernel.py).  The
// caller passes the launch geometry (V, shared bytes, blocks, chunk),
// worked out by kernel.launch_geometry; the entry point checks it again
// and returns cudaErrorInvalidValue on a value the kernels do not take.
// It launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;          // pass 1: threads a block
constexpr int kBlocks = 4;             // its resident blocks an SM, at least
constexpr int kReduceThreads = 1024;   // pass 2: its one block, 32 warps
constexpr int kUnroll = 4;             // loads a thread keeps in flight
constexpr int kMaxM = 6144;            // M * 8 bytes within 48 KB

enum IdType { kId32 = 0, kId64 = 1 };
enum CountType { kBool = 0, kCount32 = 1, kCount64 = 2 };

// V values of T loaded with one instruction where V * sizeof(T) <= 16
// (two for 32 bytes); the caller guarantees the alignment
template <typename T, int V>
struct alignas(V * sizeof(T) < 16 ? V * sizeof(T) : 16) Pack {
  T v[V];
};

template <typename C>
__device__ __forceinline__ long long as_count(C c) {
  return static_cast<long long>(c);
}
template <>
__device__ __forceinline__ long long as_count<uint8_t>(uint8_t c) {
  return c != 0;
}

// one thread's run of equal ids; flushed to the block's bins on a change
struct Run {
  int id = -1;
  unsigned long long sum = 0;

  template <typename I>
  __device__ __forceinline__ void add(I id_in, long long c, int M,
                                      unsigned long long* bins) {
    if (c == 0 || id_in < 0 || id_in >= M) return;
    const int w = static_cast<int>(id_in);
    if (w != id) {
      flush(bins);
      id = w;
    }
    sum += static_cast<unsigned long long>(c);
  }

  __device__ __forceinline__ void flush(unsigned long long* bins) {
    if (sum != 0) atomicAdd(&bins[id], sum);
    sum = 0;
  }
};

template <typename I, typename C, int V>
__global__ void __launch_bounds__(kThreads, kBlocks)
worker_count_partial(const I* __restrict__ ids, const C* __restrict__ counts,
                     long long n, int M, long long chunk,
                     unsigned long long* __restrict__ part) {
  extern __shared__ unsigned long long bins[];
  for (int m = threadIdx.x; m < M; m += kThreads) bins[m] = 0;
  __syncthreads();

  const long long n_vec = n / V;
  const long long v0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long v1 = v0 + chunk < n_vec ? v0 + chunk : n_vec;
  const Pack<I, V>* id_vec = reinterpret_cast<const Pack<I, V>*>(ids);
  const Pack<C, V>* count_vec = reinterpret_cast<const Pack<C, V>*>(counts);
  Run run;
  for (long long v = v0 + threadIdx.x; v < v1;
       v += static_cast<long long>(kThreads) * kUnroll) {
    Pack<I, V> iv[kUnroll];
    Pack<C, V> cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = v + static_cast<long long>(u) * kThreads;
      if (w < v1) {
        iv[u] = id_vec[w];
        cv[u] = count_vec[w];
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          iv[u].v[k] = 0;
          cv[u].v[k] = 0;             // a count of 0 adds nothing
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        run.add(iv[u].v[k], as_count(cv[u].v[k]), M, bins);
      }
    }
  }
  // the last block also takes the n % V ids past the last whole vector
  if (blockIdx.x == gridDim.x - 1) {
    const long long i = n_vec * V + threadIdx.x;
    if (i < n) run.add(ids[i], as_count(counts[i]), M, bins);
  }
  run.flush(bins);
  __syncthreads();
  unsigned long long* row = part + static_cast<long long>(blockIdx.x) * M;
  for (int m = threadIdx.x; m < M; m += kThreads) row[m] = bins[m];
}

__global__ void __launch_bounds__(kReduceThreads)
worker_count_total(const unsigned long long* __restrict__ part, int blocks,
                   int M, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long acc[kReduceThreads / 32][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kReduceThreads / 32;
  for (int c0 = 0; c0 < M; c0 += 32) {
    const int m = c0 + lane;
    unsigned long long s = 0;
    if (m < M) {
#pragma unroll 4
      for (int b = warp; b < blocks; b += kWarps) {
        s += part[static_cast<long long>(b) * M + m];
      }
    }
    acc[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && m < M) {
      unsigned long long t = 0;
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) t += acc[w][lane];
      out[m] = t;
    }
    __syncthreads();
  }
}

// one launch's arguments, as the entry point checked them
struct Launch {
  const void* ids;
  const void* counts;
  void* part;
  void* out;
  long long n;
  int M;
  int smem_bytes;
  long long blocks;
  long long chunk;
  cudaStream_t stream;
};

template <typename I, typename C, int V>
cudaError_t launch(const Launch& a) {
  worker_count_partial<I, C, V>
      <<<static_cast<unsigned>(a.blocks), kThreads, a.smem_bytes, a.stream>>>(
          static_cast<const I*>(a.ids), static_cast<const C*>(a.counts), a.n,
          a.M, a.chunk, static_cast<unsigned long long*>(a.part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  worker_count_total<<<1, kReduceThreads, 0, a.stream>>>(
      static_cast<const unsigned long long*>(a.part),
      static_cast<int>(a.blocks), a.M,
      static_cast<unsigned long long*>(a.out));
  return cudaSuccess;
}

template <typename I, int V>
cudaError_t launch_counts(int count_type, const Launch& a) {
  if (count_type == kBool) return launch<I, uint8_t, V>(a);
  if (count_type == kCount32) return launch<I, int32_t, V>(a);
  return launch<I, long long, V>(a);
}

int id_bytes(int id_type) { return id_type == kId32 ? 4 : 8; }
int count_bytes(int count_type) {
  return count_type == kBool ? 1 : count_type == kCount32 ? 4 : 8;
}

// the alignment a load of vec values of b bytes needs
uintptr_t load_align(int vec, int b) {
  return static_cast<uintptr_t>(vec * b < 16 ? vec * b : 16);
}

}  // namespace

// ids, counts: device pointers of (n,) contiguous arrays; id_type 0 =
// int32, 1 = int64; count_type 0 = bool, 1 = int32, 2 = int64; part: a
// (blocks, M) int64 scratch; out: the (M,) int64 result; vec (16 / id
// bytes, or 1), smem_bytes (M * 8), blocks and chunk (vectors a block) as
// kernel.launch_geometry gives them.  Returns a cudaError_t (0 on success;
// n == 0 launches nothing).
extern "C" int worker_count_launch(const void* ids, const void* counts,
                                   void* part, void* out, long long n, int M,
                                   int id_type, int count_type, int vec,
                                   int smem_bytes, long long blocks,
                                   long long chunk, int device,
                                   void* stream) {
  if (n == 0) return 0;
  if (n < 0 || M < 1 || M > kMaxM || id_type < kId32 || id_type > kId64
      || count_type < kBool || count_type > kCount64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ib = id_bytes(id_type);
  const long long n_vec = n / (vec > 0 ? vec : 1);
  if ((vec != 1 && vec != 16 / ib) || smem_bytes != M * 8 || blocks < 1
      || blocks > INT_MAX || chunk != (n_vec + blocks - 1) / blocks
      || reinterpret_cast<uintptr_t>(ids) % load_align(vec, ib) != 0
      || reinterpret_cast<uintptr_t>(counts)
             % load_align(vec, count_bytes(count_type)) != 0
      || reinterpret_cast<uintptr_t>(part) % 8 != 0
      || reinterpret_cast<uintptr_t>(out) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch a{ids, counts, part, out, n, M, smem_bytes, blocks, chunk,
                 static_cast<cudaStream_t>(stream)};
  if (id_type == kId32) {
    err = vec == 4 ? launch_counts<int32_t, 4>(count_type, a)
                   : launch_counts<int32_t, 1>(count_type, a);
  } else {
    err = vec == 2 ? launch_counts<long long, 2>(count_type, a)
                   : launch_counts<long long, 1>(count_type, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
