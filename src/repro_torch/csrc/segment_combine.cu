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
// Order.  Every slot combines the lanes that hit it in lane order,
// starting from the identity, in both kernels.  So a float sum is the same
// from run to run (no float atomics), and F=1 through the vector kernel
// equals this kernel bit for bit.
//
// The TPU kernel builds an (eb, nb) one-hot hit matrix and contracts it on
// the MXU: nb*eb multiply-adds a row where eb combines are needed.  That
// shape serves a matrix unit, not this card, and is not carried over.
//
// What bounds it.  Bytes: every input read once and every output written
// once, R*eb*8 + R*nb*4.  On the main path at n=4M vertices (M=32,
// nb=128) the Ch_msg plan is 1,387,616 x 64 and the mirror plan
// 62,950 x 512: 1.421 GB and 0.290 GB a launch, 0.424 ms and 0.087 ms at
// 3.35 TB/s.  The work is eb combines a row, far below the card's rate,
// as long as each lane is touched a constant number of times.
//
// What the design does about that.  One warp owns one row at a time;
// the grid is one wave of resident blocks and each warp walks its rows
// with the grid's stride.  The warp's accumulators acc[nb] sit in shared
// memory (0.5 KB at nb=128, with as much again of group masks).  It loads
// lane_tile lanes of values and indices at once, 32 consecutive lanes a
// load instruction (128 coalesced bytes), and issues the loads of its next
// (row, tile) before it folds the current one.  Each 32-lane chunk folds
// in one of two ways:
//  - an order-free combine (every int32 op: a wrapping sum, min, max) is
//    one shared-memory atomic a lane, whatever the order, which gives the
//    lane-order result;
//  - a float combine keeps lane order: each hitting lane ORs its bit into
//    the mask of its slot (an atomic whose result does not depend on the
//    order), so every lane learns the whole group of lanes with its slot;
//    the lowest lane of each group folds the group's values into
//    acc[slot], lowest lane first, fetching them by shuffles.  Distinct
//    groups touch distinct slots, so there are no races.
// That is eb combines a row (not nb*eb compares); the warp then writes
// acc[0:nb] out coalesced, 16 bytes a lane where nb allows.  Grouping
// with __match_any_sync instead costs more the more distinct slots a
// chunk has, and on the card that cost exceeded the bytes' time.
//
// Skew.  A row whose lanes all hit one slot (a hub that receives many
// edges from one worker) costs an int32 combine nothing extra (the
// atomics to one address serialise, 32 a chunk).  A float combine then
// has one lane fold all 32 values of each chunk while the others wait:
// eb steps a row, which a fold in lane order must do anyway, with the
// next tile's loads already in flight.  A tree over the group would
// change the float order.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W), a launch on the main path's own inputs: Ch_msg plan 0.494 ms
// for int32 min/max, 0.520 ms float32 min, 0.662 ms float32 sum (bound
// 0.424); mirror plan 0.105 / 0.124 / 0.140 ms (bound 0.087); all 264
// launches of the counted algorithm runs 109.17 ms against torch's
// scatter_reduce 375.84 ms and 82.27 ms of bound.  ptxas: 48 registers;
// the float32 sum spills 20 bytes.
//
// Interface: plain C functions, built with nvcc into one shared library and
// called through ctypes (repro_torch/kernels/segment_combine/kernel.py).
// The caller passes the launch geometry (warps a block, lane tile, vector
// width, shared bytes, blocks), worked out by kernel.launch_geometry; the
// entry points check it again and return cudaErrorInvalidValue on a value
// the kernels do not take.  They launch on the caller's stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kMaxWarps = 8;             // 256 threads a block
constexpr int kScalarBlocks = 5;         // resident blocks an SM, at least
constexpr int kVecBlocks = 4;            // (the kernels' launch bounds)
constexpr int kScalarMaxChunks = 4;      // scalar lane tile <= 128 lanes
constexpr int kVecMaxTile = 1024;        // vector lane tile (int16 perm)
constexpr int kSmemDefault = 48 * 1024;  // without the opt-in
constexpr int kSmemMax = 232448;         // 227 KB with it
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3.0e38f;
constexpr float kPos = 3.0e38f;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum DType { kInt32 = 0, kFloat32 = 1 };

// accumulator type, identity and combine step for each (type, op); ``in``
// takes a stored output back into the accumulator (a later lane tile of
// the vector kernel continues from it).  kOrderFree marks the combines
// whose result does not depend on the order of the lanes (the integer
// ones: a wrapping sum, min, max); the scalar kernel folds those with
// shared-memory atomics.
template <typename T, int OP> struct Combiner;

template <> struct Combiner<float, kSum> {
  typedef float Acc;
  static constexpr bool kOrderFree = false;
  __device__ static Acc init() { return 0.0f; }
  __device__ static Acc step(Acc a, float v) { return a + v; }
  __device__ static float out(Acc a) { return a; }
  __device__ static Acc in(float v) { return v; }
};
template <> struct Combiner<float, kMin> {
  typedef float Acc;
  static constexpr bool kOrderFree = false;  // -0 vs +0, NaN
  __device__ static Acc init() { return kPos; }
  __device__ static Acc step(Acc a, float v) { return v < a ? v : a; }
  __device__ static float out(Acc a) { return a; }
  __device__ static Acc in(float v) { return v; }
};
template <> struct Combiner<float, kMax> {
  typedef float Acc;
  static constexpr bool kOrderFree = false;
  __device__ static Acc init() { return kNeg; }
  __device__ static Acc step(Acc a, float v) { return v > a ? v : a; }
  __device__ static float out(Acc a) { return a; }
  __device__ static Acc in(float v) { return v; }
};
template <> struct Combiner<int32_t, kSum> {
  typedef uint32_t Acc;  // unsigned: wraps mod 2^32 without overflow UB
  static constexpr bool kOrderFree = true;
  __device__ static void atomic(Acc* a, int32_t v) {
    atomicAdd(a, static_cast<uint32_t>(v));
  }
  __device__ static Acc init() { return 0u; }
  __device__ static Acc step(Acc a, int32_t v) {
    return a + static_cast<uint32_t>(v);
  }
  __device__ static int32_t out(Acc a) { return static_cast<int32_t>(a); }
  __device__ static Acc in(int32_t v) { return static_cast<uint32_t>(v); }
};
template <> struct Combiner<int32_t, kMin> {
  typedef int32_t Acc;
  static constexpr bool kOrderFree = true;
  __device__ static void atomic(Acc* a, int32_t v) { atomicMin(a, v); }
  __device__ static Acc init() { return INT_MAX; }
  __device__ static Acc step(Acc a, int32_t v) { return v < a ? v : a; }
  __device__ static int32_t out(Acc a) { return a; }
  __device__ static Acc in(int32_t v) { return v; }
};
template <> struct Combiner<int32_t, kMax> {
  typedef int32_t Acc;
  static constexpr bool kOrderFree = true;
  __device__ static void atomic(Acc* a, int32_t v) { atomicMax(a, v); }
  __device__ static Acc init() { return INT_MIN; }
  __device__ static Acc step(Acc a, int32_t v) { return v > a ? v : a; }
  __device__ static int32_t out(Acc a) { return a; }
  __device__ static Acc in(int32_t v) { return v; }
};

// V values moved by one load or store instruction (V*4 bytes, aligned)
template <typename X, int V> struct alignas(sizeof(X) * V) Pack {
  X v[V];
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// shared bytes of one warp of each kernel; kernel.py computes the same
__host__ __device__ constexpr int scalar_warp_bytes(int nb) {
  return round_up(nb, 4) * 8;                      // acc[nb], group[nb]
}
__host__ __device__ constexpr int vec_warp_bytes(int nb, int lane_tile) {
  return round_up(nb, 4) * 8 + lane_tile * 2;      // end, group, perm
}

// the lanes of this chunk whose slot is i (hit), from the warp's group
// words: each hitting lane ORs its bit into group[i] (an atomic whose
// result does not depend on order), then reads the whole mask.  The
// caller clears group[i] after a __syncwarp(), before the next chunk.
__device__ __forceinline__ unsigned chunk_group(unsigned* group, int i,
                                                bool hit, int lane) {
  if (hit) atomicOr(group + i, 1u << lane);
  __syncwarp();
  const unsigned g = hit ? group[i] : 0u;
  __syncwarp();
  return g;
}

// ---------------------------------------------------------------------------
// Scalar payloads: the port of _kernel
// ---------------------------------------------------------------------------

// lanes [t*lane_tile, (t+1)*lane_tile) of row r, 32 a chunk, lane by lane;
// lanes past eb (or a row past R) get index -1, which never hits
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ vals,
                                          const int32_t* __restrict__ idx,
                                          long long R, int eb, int lane_tile,
                                          long long r, int t, int lane,
                                          T (&v)[kScalarMaxChunks],
                                          int32_t (&i)[kScalarMaxChunks]) {
#pragma unroll
  for (int c = 0; c < kScalarMaxChunks; ++c) {
    const int e = t * lane_tile + c * 32 + lane;
    v[c] = T(0);
    i[c] = -1;
    if (r < R && c * 32 < lane_tile && e < eb) {
      const long long g = r * eb + e;
      v[c] = vals[g];
      i[c] = idx[g];
    }
  }
}

// fold one 32-lane chunk into acc.  An order-free combine is one shared
// atomic a lane.  Otherwise in lane order: the lowest lane of each group
// of lanes with one slot (chunk_group) folds the group's values into
// acc[slot], fetching them by shuffles, lowest lane first; distinct groups
// touch distinct slots.
template <typename T, int OP>
__device__ __forceinline__ void fold_chunk(typename Combiner<T, OP>::Acc* acc,
                                           unsigned* group, int nb, int i,
                                           T v, int lane) {
  typedef Combiner<T, OP> C;
  const bool hit = static_cast<unsigned>(i) < static_cast<unsigned>(nb);
  if constexpr (C::kOrderFree) {
    if (hit) C::atomic(acc + i, v);
  } else {
    const unsigned g = chunk_group(group, i, hit, lane);
    const bool leader = hit && (g & ((1u << lane) - 1u)) == 0u;
    unsigned rest = leader ? g : 0u;
    const unsigned most =
        __reduce_max_sync(kFull, static_cast<unsigned>(__popc(rest)));
    typename C::Acc a = leader ? acc[i] : C::init();
    for (unsigned s = 0; s < most; ++s) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const T x = __shfl_sync(kFull, v, src);
      if (rest) {
        a = C::step(a, x);
        rest &= rest - 1u;
      }
    }
    if (leader) {
      acc[i] = a;
      group[i] = 0u;
    }
    __syncwarp();
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kMaxWarps * 32, kScalarBlocks)
segment_combine_kernel(const T* __restrict__ vals,
                       const int32_t* __restrict__ idx,
                       T* __restrict__ out, long long R, int eb, int nb,
                       int lane_tile, int quad_out) {
  typedef Combiner<T, OP> C;
  typedef typename C::Acc Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  Acc* acc = reinterpret_cast<Acc*>(smem + (threadIdx.x >> 5)
                                    * scalar_warp_bytes(nb));
  unsigned* group = reinterpret_cast<unsigned*>(acc + round_up(nb, 4));
  const long long stride = static_cast<long long>(gridDim.x) * wpb;
  const int n_tiles = eb > 0 ? (eb + lane_tile - 1) / lane_tile : 1;
  for (int n = lane; n < nb; n += 32) group[n] = 0u;

  long long r = static_cast<long long>(blockIdx.x) * wpb + (threadIdx.x >> 5);
  int t = 0;
  T nv[kScalarMaxChunks];
  int32_t ni[kScalarMaxChunks];
  load_tile(vals, idx, R, eb, lane_tile, r, t, lane, nv, ni);
  while (r < R) {                        // r is the same for the whole warp
    T cv[kScalarMaxChunks];
    int32_t ci[kScalarMaxChunks];
#pragma unroll
    for (int c = 0; c < kScalarMaxChunks; ++c) {
      cv[c] = nv[c];
      ci[c] = ni[c];
    }
    long long r2 = r;
    int t2 = t + 1;
    if (t2 == n_tiles) {
      t2 = 0;
      r2 += stride;
    }
    load_tile(vals, idx, R, eb, lane_tile, r2, t2, lane, nv, ni);  // ahead
    if (t == 0) {
      for (int n = lane; n < nb; n += 32) acc[n] = C::init();
      __syncwarp();
    }
#pragma unroll
    for (int c = 0; c < kScalarMaxChunks; ++c) {
      if (c * 32 < lane_tile && t * lane_tile + c * 32 < eb) {
        fold_chunk<T, OP>(acc, group, nb, ci[c], cv[c], lane);
      }
    }
    if (t2 == 0) {                       // the row's last tile: write it
      __syncwarp();
      T* o = out + r * nb;
      if (quad_out) {
        const Pack<Acc, 4>* a4 = reinterpret_cast<const Pack<Acc, 4>*>(acc);
        Pack<T, 4>* o4 = reinterpret_cast<Pack<T, 4>*>(o);
        for (int q = lane; q < nb / 4; q += 32) {
          const Pack<Acc, 4> a = a4[q];
          Pack<T, 4> y;
#pragma unroll
          for (int k = 0; k < 4; ++k) y.v[k] = C::out(a.v[k]);
          o4[q] = y;
        }
      } else {
        for (int n = lane; n < nb; n += 32) o[n] = C::out(acc[n]);
      }
      __syncwarp();
    }
    r = r2;
    t = t2;
  }
}


// ---------------------------------------------------------------------------
// Feature-blocked payloads: the port of _kernel_vec
// ---------------------------------------------------------------------------
//
// What it computes.  vals is (R, eb, F) row-major, idx (R, eb) as above,
// out (R, nb, F):
//     out[r, n, f] = op over the lanes e of row r with idx[r, e] == n
//                    of vals[r, e, f]
// Features never mix.  Identities, accumulation types, the int32 wrap and
// the order (each slot's lanes in lane order, from the identity) are the
// scalar kernel's, so F=1 gives the scalar kernel's result bit for bit.
//
// The TPU kernel contracts an (eb, nb) one-hot hit matrix with the
// (eb, 128) value tile on the MXU for sum, and for min/max walks 8-column
// chunks of an (eb, nb, 8) select: R*eb*nb*F operations.  Every lane hits
// at most one slot, so an indexed fold does R*eb*F instead.
//
// What bounds it.  Bytes: every value and index read once and every
// output written once, R*eb*(4F+4) + R*nb*4F.  The output is dense (nb
// slots a row, whatever the lanes hit), so it outweighs the input: the
// Ch_msg plan at n=4M (1,387,616 rows x eb=64, nb=128) moves 34.5 GB a
// join at F=32 and 68.6 GB at F=64, 10.3 ms and 20.5 ms at 3.35 TB/s.
//
// What the design does about that.  Enough bytes must be in flight, so
// no warp may hold nb x 32 accumulators in shared memory (16 KB at
// nb=128, about 12 warps an SM), and loads, folds and stores must
// overlap.  One warp owns one row:
//  1. Sort.  It builds the row's stable counting sort of lanes by slot in
//     its own shared words: end[nb] and group[nb] (int32) and
//     perm[lane_tile] (int16): 1.1 KB at eb=64, nb=128, 2 KB at eb=512.
//     Pass one counts each slot's lanes (shared atomicAdd: counts do not
//     depend on order), a warp scan turns the counts into starts, and
//     pass two places each lane after the earlier lanes of its slot: a
//     running cursor for earlier chunks plus its rank among its chunk's
//     lanes of that slot, read from the chunk's group mask as in the
//     scalar kernel.
//  2. Walk.  Lane t owns V consecutive features (V in {1, 2, 4}, from F
//     and the data's alignment, one V*4-byte load), 32*V features a
//     feature tile.  The warp walks the sorted lanes in order, 16/V of
//     them loaded together (64 bytes a thread in flight), folding each
//     into V accumulators in registers; when the walk passes the end of
//     slot n it stores out[r, n, :] straight away (the identity for an
//     empty slot).  The control flow depends only on the row's indices,
//     so the warp never diverges; the loads of the next lanes and the
//     stores of the slots they close overlap.  The permutation is built
//     once a row and reused for every feature tile.
// Occupancy is set by registers (the launch bounds: 4 blocks of 8 warps an
// SM), not by accumulators.  A row longer than lane_tile (1024) lanes goes
// through in lane tiles: the first writes every slot, each later one
// continues the slots it hits from the stored value, which keeps lane
// order.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W), a GCN join on the main path's own inputs: Ch_msg 11.22 ms at
// F=32 and 21.24 ms at F=64 (bound 10.29, 20.47), mirror 1.97 / 3.20 ms
// (bound 1.58, 3.12); all 888 launches of a 4-epoch GCN run 301.11 ms
// against torch.zeros + index_add_ 914.10 ms and 283.57 ms of bound.
// ptxas: 62-64 registers, no spills.

// V values of type T in one load or store
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// the row's lanes [0, len) of this lane tile sorted by slot, stable: on
// return perm[0:end[nb-1]] lists the hitting lanes, slot n's at
// [n ? end[n-1] : 0, end[n]), each slot's in lane order.  ``end`` holds
// the slots' counts, then their cursors; ``group`` the chunk masks.
__device__ __forceinline__ void sort_lanes(const int32_t* __restrict__ ix,
                                           int len, int nb, int* end,
                                           unsigned* group, int16_t* perm,
                                           int lane) {
  for (int n = lane; n < nb; n += 32) end[n] = 0;
  __syncwarp();
  for (int c0 = 0; c0 < len; c0 += 32) {           // pass one: counts
    const int e = c0 + lane;
    const int i = e < len ? ix[e] : -1;
    if (static_cast<unsigned>(i) < static_cast<unsigned>(nb)) {
      atomicAdd(end + i, 1);
    }
  }
  __syncwarp();
  // exclusive scan: lane owns the slots [lo, hi)
  const int per = (nb + 31) / 32;
  const int lo = min(nb, lane * per);
  const int hi = min(nb, lo + per);
  int sum = 0;
  for (int n = lo; n < hi; ++n) sum += end[n];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int run = incl - sum;
  for (int n = lo; n < hi; ++n) {
    const int c = end[n];
    end[n] = run;
    run += c;
  }
  __syncwarp();
  // pass two: each lane goes after the earlier lanes of its slot, those
  // of earlier chunks (the cursor) and of its own (its rank in the group)
  for (int c0 = 0; c0 < len; c0 += 32) {
    const int e = c0 + lane;
    const int i = e < len ? ix[e] : -1;
    const bool hit = static_cast<unsigned>(i) < static_cast<unsigned>(nb);
    const unsigned g = chunk_group(group, i, hit, lane);
    const unsigned below = g & ((1u << lane) - 1u);
    const int at = hit ? end[i] : 0;
    __syncwarp();                        // every read before the update
    if (hit) {
      perm[at + __popc(below)] = static_cast<int16_t>(e);
      if (below == 0u) {
        end[i] = at + __popc(g);
        group[i] = 0u;
      }
    }
    __syncwarp();
  }
}

// slot n's accumulators at the start of its lanes: the identity, or in a
// later lane tile the value stored so far
template <typename T, int OP, int V>
__device__ __forceinline__ void open_slot(typename Combiner<T, OP>::Acc (&acc)[V],
                                          const T* o, bool resume) {
  typedef Combiner<T, OP> C;
  if (resume) {
    const Pack<T, V> y = load_pack<T, V>(o);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = C::in(y.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = C::init();
  }
}

template <typename T, int OP, int V>
__device__ __forceinline__ void close_slot(
    const typename Combiner<T, OP>::Acc (&acc)[V], T* o) {
  typedef Combiner<T, OP> C;
  Pack<T, V> y;
#pragma unroll
  for (int k = 0; k < V; ++k) y.v[k] = C::out(acc[k]);
  *reinterpret_cast<Pack<T, V>*>(o) = y;
}

// fold the sorted lanes of one (row, lane tile, feature tile) and store
// the slots; v and o point at this lane's features of the tile's first
// lane and of the row's slot 0
template <typename T, int OP, int V>
__device__ __forceinline__ void walk(const T* __restrict__ v,
                                     T* __restrict__ o, int F, int nb,
                                     const int* end, const int16_t* perm,
                                     bool live, bool first) {
  typedef Combiner<T, OP> C;
  constexpr int kDepth = 16 / V;       // lanes loaded together: 64 B a thread
  typename C::Acc acc[V];
  const int n_hit = end[nb - 1];
  int n = 0, lo = 0, hi = end[0];      // slot n's lanes are perm[lo:hi]
  open_slot<T, OP, V>(acc, o, live && !first && lo < hi);
  for (int kb = 0; kb < n_hit; kb += kDepth) {
    Pack<T, V> x[kDepth];
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int k = kb + j;
      if (live && k < n_hit) {
        x[j] = load_pack<T, V>(v + static_cast<long long>(perm[k]) * F);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) x[j].v[q] = T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int k = kb + j;
      if (k < n_hit) {
        while (k >= hi) {              // close slot n, open the next
          if (live && (first || lo < hi)) {
            close_slot<T, OP, V>(acc, o + static_cast<long long>(n) * F);
          }
          ++n;
          lo = hi;
          hi = end[n];
          open_slot<T, OP, V>(acc, o + static_cast<long long>(n) * F,
                              live && !first && lo < hi);
        }
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = C::step(acc[q], x[j].v[q]);
      }
    }
  }
  for (;;) {                           // the slots after the last lane
    if (live && (first || lo < hi)) {
      close_slot<T, OP, V>(acc, o + static_cast<long long>(n) * F);
    }
    if (++n >= nb) break;
    lo = hi;
    hi = end[n];
    open_slot<T, OP, V>(acc, o + static_cast<long long>(n) * F,
                        live && !first && lo < hi);
  }
}

template <typename T, int OP, int V>
__global__ void __launch_bounds__(kMaxWarps * 32, kVecBlocks)
segment_combine_vec_kernel(const T* __restrict__ vals,
                           const int32_t* __restrict__ idx,
                           T* __restrict__ out, long long R, int eb, int nb,
                           int F, int lane_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  int* end = reinterpret_cast<int*>(
      smem + (threadIdx.x >> 5) * vec_warp_bytes(nb, lane_tile));
  unsigned* group = reinterpret_cast<unsigned*>(end + round_up(nb, 4));
  int16_t* perm = reinterpret_cast<int16_t*>(group + round_up(nb, 4));
  for (int n = lane; n < nb; n += 32) group[n] = 0u;
  const int n_vec = F / V;
  const int n_ft = (n_vec + 31) / 32;
  const int n_lt = eb > 0 ? (eb + lane_tile - 1) / lane_tile : 1;
  const long long stride = static_cast<long long>(gridDim.x) * wpb;
  for (long long r = static_cast<long long>(blockIdx.x) * wpb
                     + (threadIdx.x >> 5);
       r < R; r += stride) {             // r is the same for the whole warp
    for (int lt = 0; lt < n_lt; ++lt) {
      const int l0 = lt * lane_tile;
      const int len = min(lane_tile, eb - l0);
      sort_lanes(idx + r * eb + l0, len, nb, end, group, perm, lane);
      for (int ft = 0; ft < n_ft; ++ft) {
        const int vi = ft * 32 + lane;
        const long long f = static_cast<long long>(vi) * V;
        walk<T, OP, V>(vals + (r * eb + l0) * F + f, out + r * nb * F + f,
                       F, nb, end, perm, vi < n_vec, lt == 0);
      }
      __syncwarp();                      // end/perm are reused next
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the geometry both kernels share: warps a block, shared bytes, blocks
bool block_ok(int warps, int smem_bytes, long long blocks) {
  return warps >= 1 && warps <= kMaxWarps && smem_bytes >= 0
         && smem_bytes <= kSmemMax && blocks >= 1 && blocks <= INT_MAX;
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem_bytes) {
  if (smem_bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

template <typename T, int OP>
cudaError_t launch(const void* vals, const void* idx, void* out, long long R,
                   int eb, int nb, int lane_tile, int quad_out, int warps,
                   int smem_bytes, long long blocks, cudaStream_t stream) {
  const cudaError_t err = allow_smem(segment_combine_kernel<T, OP>,
                                     smem_bytes);
  if (err != cudaSuccess) return err;
  segment_combine_kernel<T, OP>
      <<<static_cast<unsigned>(blocks), warps * 32, smem_bytes, stream>>>(
          static_cast<const T*>(vals), static_cast<const int32_t*>(idx),
          static_cast<T*>(out), R, eb, nb, lane_tile, quad_out);
  return cudaSuccess;
}

template <typename T, int OP, int V>
cudaError_t launch_vec(const void* vals, const void* idx, void* out,
                       long long R, int eb, int nb, int F, int lane_tile,
                       int warps, int smem_bytes, long long blocks,
                       cudaStream_t stream) {
  const cudaError_t err = allow_smem(segment_combine_vec_kernel<T, OP, V>,
                                     smem_bytes);
  if (err != cudaSuccess) return err;
  segment_combine_vec_kernel<T, OP, V>
      <<<static_cast<unsigned>(blocks), warps * 32, smem_bytes, stream>>>(
          static_cast<const T*>(vals), static_cast<const int32_t*>(idx),
          static_cast<T*>(out), R, eb, nb, F, lane_tile);
  return cudaSuccess;
}

template <typename T, int V>
cudaError_t launch_vec_op(int op, const void* vals, const void* idx,
                          void* out, long long R, int eb, int nb, int F,
                          int lane_tile, int warps, int smem_bytes,
                          long long blocks, cudaStream_t s) {
  if (op == kSum) return launch_vec<T, kSum, V>(vals, idx, out, R, eb, nb, F, lane_tile, warps, smem_bytes, blocks, s);
  if (op == kMin) return launch_vec<T, kMin, V>(vals, idx, out, R, eb, nb, F, lane_tile, warps, smem_bytes, blocks, s);
  return launch_vec<T, kMax, V>(vals, idx, out, R, eb, nb, F, lane_tile, warps, smem_bytes, blocks, s);
}

template <typename T>
cudaError_t launch_vec_width(int vec, int op, const void* vals,
                             const void* idx, void* out, long long R, int eb,
                             int nb, int F, int lane_tile, int warps,
                             int smem_bytes, long long blocks,
                             cudaStream_t s) {
  if (vec == 4) return launch_vec_op<T, 4>(op, vals, idx, out, R, eb, nb, F, lane_tile, warps, smem_bytes, blocks, s);
  if (vec == 2) return launch_vec_op<T, 2>(op, vals, idx, out, R, eb, nb, F, lane_tile, warps, smem_bytes, blocks, s);
  return launch_vec_op<T, 1>(op, vals, idx, out, R, eb, nb, F, lane_tile, warps, smem_bytes, blocks, s);
}

}  // namespace

// vals, idx, out: device pointers of (R, eb), (R, eb) int32 and (R, nb)
// contiguous arrays; dtype 0 = int32, 1 = float32; op 0 = sum, 1 = min,
// 2 = max; warps, lane_tile, smem_bytes and blocks as
// kernel.launch_geometry gives them.  Returns a cudaError_t (0 on
// success).
extern "C" int segment_combine_launch(const void* vals, const void* idx,
                                      void* out, long long R, int eb,
                                      int nb, int dtype, int op, int warps,
                                      int lane_tile, int smem_bytes,
                                      long long blocks, int device,
                                      void* stream) {
  if (R <= 0) return 0;
  if (nb < 1 || nb > 1024 || eb < 0 || (dtype != kInt32 && dtype != kFloat32)
      || op < kSum || op > kMax || !block_ok(warps, smem_bytes, blocks)
      || lane_tile < 32 || lane_tile > 32 * kScalarMaxChunks
      || lane_tile % 32 != 0 || smem_bytes != warps * scalar_warp_bytes(nb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int quad_out = nb % 4 == 0
                       && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kInt32) {
    if (op == kSum) err = launch<int32_t, kSum>(vals, idx, out, R, eb, nb, lane_tile, quad_out, warps, smem_bytes, blocks, s);
    else if (op == kMin) err = launch<int32_t, kMin>(vals, idx, out, R, eb, nb, lane_tile, quad_out, warps, smem_bytes, blocks, s);
    else err = launch<int32_t, kMax>(vals, idx, out, R, eb, nb, lane_tile, quad_out, warps, smem_bytes, blocks, s);
  } else {
    if (op == kSum) err = launch<float, kSum>(vals, idx, out, R, eb, nb, lane_tile, quad_out, warps, smem_bytes, blocks, s);
    else if (op == kMin) err = launch<float, kMin>(vals, idx, out, R, eb, nb, lane_tile, quad_out, warps, smem_bytes, blocks, s);
    else err = launch<float, kMax>(vals, idx, out, R, eb, nb, lane_tile, quad_out, warps, smem_bytes, blocks, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// vals, idx, out: device pointers of (R, eb, F), (R, eb) int32 and
// (R, nb, F) contiguous arrays; dtype and op as above; vec (1, 2 or 4
// features a thread, dividing F, vals and out aligned to vec*4 bytes),
// warps, lane_tile, smem_bytes and blocks as kernel.launch_geometry gives
// them.  Returns a cudaError_t (0 on success).
extern "C" int segment_combine_vec_launch(const void* vals, const void* idx,
                                          void* out, long long R, int eb,
                                          int nb, int F, int dtype, int op,
                                          int vec, int warps, int lane_tile,
                                          int smem_bytes, long long blocks,
                                          int device, void* stream) {
  if (R <= 0 || F <= 0) return 0;
  const uintptr_t align = static_cast<uintptr_t>(vec) * 4;
  if (nb < 1 || nb > 1024 || eb < 0 || (dtype != kInt32 && dtype != kFloat32)
      || op < kSum || op > kMax || !block_ok(warps, smem_bytes, blocks)
      || (vec != 1 && vec != 2 && vec != 4) || F % vec != 0
      || reinterpret_cast<uintptr_t>(vals) % align != 0
      || reinterpret_cast<uintptr_t>(out) % align != 0
      || lane_tile < 32 || lane_tile > kVecMaxTile || lane_tile % 32 != 0
      || smem_bytes != warps * vec_warp_bytes(nb, lane_tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kInt32) {
    err = launch_vec_width<int32_t>(vec, op, vals, idx, out, R, eb, nb, F,
                                    lane_tile, warps, smem_bytes, blocks, s);
  } else {
    err = launch_vec_width<float>(vec, op, vals, idx, out, R, eb, nb, F,
                                  lane_tile, warps, smem_bytes, blocks, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
