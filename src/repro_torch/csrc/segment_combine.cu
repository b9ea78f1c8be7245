// Blocked segment combine for Hopper (sm_90a): the port's kernels for
// src/repro/kernels/segment_combine/kernel.py::_kernel (scalar payloads)
// and ::_kernel_vec (feature-blocked payloads), the TPU kernels behind
// segment_combine_blocks.  This header is the scalar kernel's; the vector
// kernel's is further down, above segment_combine_vec_kernel.
//
// What it computes.  vals and idx are (R, eb) row-major; idx holds
// block-local destinations in [0, nb) and -1 for padding.  For every row r
// and slot n in [0, nb):
//     out[r, n] = op over the lanes e of row r with idx[r, e] == n
// with op in {sum, min, max}.  A slot no lane hits holds the identity of
// the TPU kernel: 0 for sum; for min/max the finite sentinels +-3e38 for
// float32 and the iinfo bounds for int32.  Sums accumulate in float32
// (in uint32 for int32, so they wrap as the TPU kernel's int32 sum does)
// and are stored in the input type.  An index outside [0, nb) never hits.
//
// The TPU kernel builds an (eb, nb) one-hot hit matrix and contracts it on
// the MXU.  That shape serves a matrix unit, not this card, and is not
// carried over.  Here each thread owns one output slot (r, n) and scans
// row r's lanes in lane order, so a float sum is the same from run to run
// (no atomics).
//
// What bounds it.  The least work is to read every input once and write
// every output once: R*eb*8 + R*nb*4 bytes.  On the main path at n=4M
// vertices (M=32, nb=128) the Ch_msg plan is 1,387,616 x 64 and the
// mirror plan 62,950 x 512, which is 1.421 GB and 0.290 GB per launch,
// 0.424 ms and 0.087 ms at 3.35 TB/s.  The scan does nb*eb compares per
// row, 1.1e10 for that Ch_msg plan, so this simple design is bound by
// instructions, not bytes, on wide blocks; what it does about the bytes:
// each block stages its rows' lanes in shared memory with coalesced loads
// (consecutive threads read consecutive words), reads each input byte
// from device memory once, and writes its outputs coalesced.  Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit 700 W): 3.5 ms
// for that Ch_msg plan and 1.05 ms for the mirror plan, 8x and 12x the
// bound; replacing the scan (sorted lanes, warp-level segmented reduce)
// is the next step.
//
// Layout of one launch.  A block of rpb*nb threads handles rpb
// consecutive rows (rpb = max(1, 256 / nb)); thread t owns row t / nb and
// slot t % nb.  The rows' lanes go through shared memory in tiles of at
// most lane_tile lanes, sized to stay within 32 KB.  All shared reads
// within a warp are of one address (a broadcast), so there are no bank
// conflicts.
//
// Interface: plain C functions, built with nvcc into one shared library and
// called through ctypes (repro_torch/kernels/segment_combine/kernel.py).
// They launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;         // threads a block aims for
constexpr int kSmemBytes = 32 * 1024;  // shared memory a block stages
constexpr float kNeg = -3.0e38f;
constexpr float kPos = 3.0e38f;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum DType { kInt32 = 0, kFloat32 = 1 };

// accumulator type, identity and combine step for each (type, op)
template <typename T, int OP> struct Combiner;

template <> struct Combiner<float, kSum> {
  typedef float Acc;
  __device__ static Acc init() { return 0.0f; }
  __device__ static Acc step(Acc a, float v) { return a + v; }
  __device__ static float out(Acc a) { return a; }
};
template <> struct Combiner<float, kMin> {
  typedef float Acc;
  __device__ static Acc init() { return kPos; }
  __device__ static Acc step(Acc a, float v) { return v < a ? v : a; }
  __device__ static float out(Acc a) { return a; }
};
template <> struct Combiner<float, kMax> {
  typedef float Acc;
  __device__ static Acc init() { return kNeg; }
  __device__ static Acc step(Acc a, float v) { return v > a ? v : a; }
  __device__ static float out(Acc a) { return a; }
};
template <> struct Combiner<int32_t, kSum> {
  typedef uint32_t Acc;  // unsigned: wraps mod 2^32 without overflow UB
  __device__ static Acc init() { return 0u; }
  __device__ static Acc step(Acc a, int32_t v) {
    return a + static_cast<uint32_t>(v);
  }
  __device__ static int32_t out(Acc a) { return static_cast<int32_t>(a); }
};
template <> struct Combiner<int32_t, kMin> {
  typedef int32_t Acc;
  __device__ static Acc init() { return INT_MAX; }
  __device__ static Acc step(Acc a, int32_t v) { return v < a ? v : a; }
  __device__ static int32_t out(Acc a) { return a; }
};
template <> struct Combiner<int32_t, kMax> {
  typedef int32_t Acc;
  __device__ static Acc init() { return INT_MIN; }
  __device__ static Acc step(Acc a, int32_t v) { return v > a ? v : a; }
  __device__ static int32_t out(Acc a) { return a; }
};

template <typename T, int OP>
__global__ void __launch_bounds__(1024)
segment_combine_kernel(const T* __restrict__ vals,
                       const int32_t* __restrict__ idx,
                       T* __restrict__ out, long long R, int eb, int nb,
                       int rpb, int lane_tile) {
  typedef Combiner<T, OP> C;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_val = reinterpret_cast<T*>(smem);
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_val + rpb * lane_tile);

  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long left = R - r0;
  const int rows_here = left < rpb ? static_cast<int>(left) : rpb;
  const int t = threadIdx.x;
  const int lr = t / nb;          // row of this thread within the block
  const int n = t - lr * nb;      // its output slot
  const bool owns = lr < rows_here;

  typename C::Acc acc = C::init();
  for (int l0 = 0; l0 < eb; l0 += lane_tile) {
    const int len = min(lane_tile, eb - l0);
    // coalesced: with len == eb the block reads one contiguous range
    for (int k = t; k < rows_here * len; k += blockDim.x) {
      const int rr = k / len;
      const int e = k - rr * len;
      const long long g = (r0 + rr) * eb + l0 + e;
      s_val[rr * lane_tile + e] = vals[g];
      s_idx[rr * lane_tile + e] = idx[g];
    }
    __syncthreads();
    if (owns) {
      const T* v = s_val + lr * lane_tile;
      const int32_t* ix = s_idx + lr * lane_tile;
      for (int e = 0; e < len; ++e) {
        if (ix[e] == n) acc = C::step(acc, v[e]);
      }
    }
    __syncthreads();
  }
  if (owns) out[(r0 + lr) * nb + n] = C::out(acc);
}

template <typename T, int OP>
void launch(const void* vals, const void* idx, void* out, long long R,
            int eb, int nb, int rpb, int lane_tile, dim3 grid,
            cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(rpb) * lane_tile * (sizeof(T) + sizeof(int32_t));
  segment_combine_kernel<T, OP><<<grid, rpb * nb, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), R, eb, nb, rpb, lane_tile);
}


// ---------------------------------------------------------------------------
// Feature-blocked payloads: the port of _kernel_vec
// ---------------------------------------------------------------------------
//
// What it computes.  vals is (R, eb, F) row-major, idx (R, eb) as above,
// out (R, nb, F):
//     out[r, n, f] = op over the lanes e of row r with idx[r, e] == n
//                    of vals[r, e, f]
// Features never mix.  Identities, accumulation types and the int32 wrap
// are the scalar kernel's, and so is the order: each slot combines its
// lanes in lane order, so F=1 gives the scalar kernel's result bit for bit.
//
// The TPU kernel contracts an (eb, nb) one-hot hit matrix with the
// (eb, 128) value tile on the MXU for sum, and for min/max walks 8-column
// chunks of an (eb, nb, 8) select: R*eb*nb*F operations.  Every lane hits
// exactly one slot, so an indexed accumulate does R*eb*F instead, and that
// is what runs here.
//
// What bounds it.  Bytes: every value and index read once and every
// output written once, R*eb*(4F+4) + R*nb*4F.  The output is dense
// (nb slots per row whatever the lanes hit), so it outweighs the input:
// the Ch_msg plan at n=4M (1,387,616 rows x eb=64, nb=128) moves 34.5 GB
// at F=32 and 68.6 GB at F=64, 10.3 ms and 20.5 ms at 3.35 TB/s; the
// work is one combine per lane and feature, far below the card's rate.
// What the design does about the bytes: a warp owns one (row, 32-feature
// tile); lane t of the warp owns feature column f0+t.  The warp reads the
// row's indices once, 32 at a time, coalesced, and passes each to every
// lane with a shuffle; the values vals[r, e, f0:f0+32] of a lane e are
// one coalesced 128-byte read, issued kBatch lanes ahead of their use.
// Each lane keeps its column's nb accumulators in shared memory
// (acc[n][t], 32 words per slot: a warp's accesses at one slot touch 32
// banks, no conflicts) and writes them out at the end, nb coalesced
// 128-byte stores.  No atomics, no block-wide barriers: a lane reads and
// writes only its own column.
//
// Layout of one launch.  A block holds wpb warps, as many as fit in
// kVecSmemBytes of accumulators (nb*32*4 bytes a warp: 4 warps at nb=128,
// one at nb=1024, which needs 128 KB and the opt-in above 48 KB).  Warp w
// of block b takes task b*wpb + w, which is row task / n_ft and feature
// tile task % n_ft; lanes past F in the last tile only take part in the
// shuffles.

constexpr int kVecSmemBytes = 64 * 1024;  // accumulators a block aims for
constexpr int kVecMaxWarps = 8;
constexpr int kBatch = 8;                // lanes whose values load together

template <typename T, int OP>
__global__ void __launch_bounds__(kVecMaxWarps * 32)
segment_combine_vec_kernel(const T* __restrict__ vals,
                           const int32_t* __restrict__ idx,
                           T* __restrict__ out, long long tasks, int n_ft,
                           int eb, int nb, int F) {
  typedef Combiner<T, OP> C;
  typedef typename C::Acc Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (task >= tasks) return;  // a whole warp: no barrier follows
  Acc* acc = reinterpret_cast<Acc*>(smem)
             + static_cast<size_t>(warp) * nb * 32 + lane;
  const long long r = task / n_ft;
  const int f = static_cast<int>(task - r * n_ft) * 32 + lane;
  const bool live = f < F;
  for (int n = 0; n < nb; ++n) acc[n * 32] = C::init();

  const T* v = vals + r * eb * static_cast<long long>(F) + f;
  const int32_t* ix = idx + r * eb;
  for (int e0 = 0; e0 < eb; e0 += 32) {
    const int len = min(32, eb - e0);
    const int mine = lane < len ? ix[e0 + lane] : -1;
    int j = 0;
    for (; j + kBatch <= len; j += kBatch) {
      T x[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        x[k] = live ? v[static_cast<long long>(e0 + j + k) * F] : T(0);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int s = __shfl_sync(0xffffffffu, mine, j + k);
        if (live && s >= 0 && s < nb) acc[s * 32] = C::step(acc[s * 32], x[k]);
      }
    }
    for (; j < len; ++j) {
      const int s = __shfl_sync(0xffffffffu, mine, j);
      if (live && s >= 0 && s < nb) {
        acc[s * 32] =
            C::step(acc[s * 32], v[static_cast<long long>(e0 + j) * F]);
      }
    }
  }
  if (live) {
    T* o = out + r * nb * static_cast<long long>(F) + f;
    for (int n = 0; n < nb; ++n) {
      o[static_cast<long long>(n) * F] = C::out(acc[n * 32]);
    }
  }
}

template <typename T, int OP>
cudaError_t launch_vec(const void* vals, const void* idx, void* out,
                       long long tasks, int n_ft, int eb, int nb, int F,
                       int wpb, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(wpb) * nb * 32 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_combine_vec_kernel<T, OP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (tasks + wpb - 1) / wpb;
  segment_combine_vec_kernel<T, OP>
      <<<static_cast<unsigned>(blocks), wpb * 32, smem, stream>>>(
          static_cast<const T*>(vals), static_cast<const int32_t*>(idx),
          static_cast<T*>(out), tasks, n_ft, eb, nb, F);
  return cudaSuccess;
}

}  // namespace

// vals, idx, out: device pointers of (R, eb), (R, eb) int32 and (R, nb)
// contiguous arrays; dtype 0 = int32, 1 = float32; op 0 = sum, 1 = min,
// 2 = max.  Returns a cudaError_t (0 on success).
extern "C" int segment_combine_launch(const void* vals, const void* idx,
                                      void* out, long long R, int eb,
                                      int nb, int dtype, int op,
                                      int device, void* stream) {
  if (R <= 0) return 0;
  if (nb < 1 || nb > 1024 || eb < 0 || (dtype != kInt32 && dtype != kFloat32)
      || op < kSum || op > kMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rpb = kThreads / nb;
  if (rpb < 1) rpb = 1;
  if (rpb > R) rpb = static_cast<int>(R);
  int lane_tile = kSmemBytes / (8 * rpb);
  if (lane_tile > eb) lane_tile = eb;
  if (lane_tile < 1) lane_tile = 1;
  const long long blocks = (R + rpb - 1) / rpb;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kInt32) {
    if (op == kSum) launch<int32_t, kSum>(vals, idx, out, R, eb, nb, rpb, lane_tile, grid, s);
    else if (op == kMin) launch<int32_t, kMin>(vals, idx, out, R, eb, nb, rpb, lane_tile, grid, s);
    else launch<int32_t, kMax>(vals, idx, out, R, eb, nb, rpb, lane_tile, grid, s);
  } else {
    if (op == kSum) launch<float, kSum>(vals, idx, out, R, eb, nb, rpb, lane_tile, grid, s);
    else if (op == kMin) launch<float, kMin>(vals, idx, out, R, eb, nb, rpb, lane_tile, grid, s);
    else launch<float, kMax>(vals, idx, out, R, eb, nb, rpb, lane_tile, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals, idx, out: device pointers of (R, eb, F), (R, eb) int32 and
// (R, nb, F) contiguous arrays; dtype and op as above.  Returns a
// cudaError_t (0 on success).
extern "C" int segment_combine_vec_launch(const void* vals, const void* idx,
                                          void* out, long long R, int eb,
                                          int nb, int F, int dtype, int op,
                                          int device, void* stream) {
  if (R <= 0 || F <= 0) return 0;
  if (nb < 1 || nb > 1024 || eb < 0 || (dtype != kInt32 && dtype != kFloat32)
      || op < kSum || op > kMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int wpb = kVecSmemBytes / (nb * 32 * 4);
  if (wpb < 1) wpb = 1;
  if (wpb > kVecMaxWarps) wpb = kVecMaxWarps;
  const int n_ft = (F + 31) / 32;
  const long long tasks = R * n_ft;
  if ((tasks + wpb - 1) / wpb > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tasks < wpb) wpb = static_cast<int>(tasks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kInt32) {
    if (op == kSum) err = launch_vec<int32_t, kSum>(vals, idx, out, tasks, n_ft, eb, nb, F, wpb, s);
    else if (op == kMin) err = launch_vec<int32_t, kMin>(vals, idx, out, tasks, n_ft, eb, nb, F, wpb, s);
    else err = launch_vec<int32_t, kMax>(vals, idx, out, tasks, n_ft, eb, nb, F, wpb, s);
  } else {
    if (op == kSum) err = launch_vec<float, kSum>(vals, idx, out, tasks, n_ft, eb, nb, F, wpb, s);
    else if (op == kMin) err = launch_vec<float, kMin>(vals, idx, out, tasks, n_ft, eb, nb, F, wpb, s);
    else err = launch_vec<float, kMax>(vals, idx, out, tasks, n_ft, eb, nb, F, wpb, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
