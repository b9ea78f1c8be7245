// Flash attention for Hopper (sm_90a): the port's kernel for
// src/repro/kernels/flash_attention/kernel.py::_kernel, the TPU kernel
// behind flash_attention_bhsd.
//
// What it computes.  q is (BH, Sq, d), k and v are (BKV, Sk, d), row-major,
// float32, bfloat16 or float16; BH = BKV * n_rep and query row bh reads kv row
// bh / n_rep (grouped-query attention; the repeat is never materialised).
// With positions 0.. on both sides (prefill and full forward; and
// cross-attention, a decoder's Sq queries against an encoder's Sk frames
// with no mask, where Sq may exceed Sk):
//     s[q, k] = (q . k) * d^-1/2        where the mask keeps (q, k),
//               NEG = -2^30              elsewhere;
//     out[q]  = sum_k softmax_k(s[q, :]) v[k]
// with the mask "k <= q" when causal and "q - k < window" when window > 0.
// Scores, the running max m, the running denominator l and the output
// accumulator are float32; l is clamped at 1e-30 before the division, and
// the output has q's type.  These are the TPU kernel's rules.
//
// Skipped tiles.  A key tile that the mask removes for every query of the
// query tile is not read.  That is exact: the TPU kernel processes such a
// tile, but each of its scores is NEG, so its weight exp(NEG - m) is 0
// once m is a real score, and while m is still NEG (no valid key seen
// yet) its weight 1 is wiped by alpha = exp(NEG - m_real) = 0 when the
// first valid key arrives.  Every query has a valid key: with no mask all
// Sk >= 1 of them, whatever Sq; under a causal mask or a window its own
// position, because there Sq <= Sk, which the wrapper and the entry point
// require.  So every row sees one.
// Keys at or past Sk (the ragged last tile) and queries at or past Sq are
// masked the same way, so any length is taken.  A tile that the mask keeps
// whole skips the mask's compares.
//
// What bounds it.  4*d operations for every query-key pair the mask keeps
// (QK^T and PV, one FMA = 2 operations each), in float32 FMA outside the
// tensor cores: 67 TFLOP/s on an H100 SXM.  At Hymba-1.5B's prefill (B=4,
// 25 query heads, S=2048, d=64) a window-1024 layer keeps 4.0e10
// operations' worth of pairs (0.60 ms) and a global layer 5.4e10
// (0.80 ms); its bytes (q, k, v read once, out written once, 126 MB) take
// 0.04 ms, so operations bound it.  What the design does about that:
//   - register tiles: each thread keeps RM x 8 scores (RM = 8 rows for
//     d <= 64, 4 for d = 128, 2 for d = 256) and the matching RM x d/8
//     outputs (64 at d >= 64) in
//     registers, so that every float it loads from shared memory feeds 4
//     FMAs (QK^T: RM + 8 float4 loads for 32 RM FMAs; PV: RM + d/8 floats
//     a key for RM d/8 FMAs).  The SM's 32 shared floats a clock then feed
//     its 128 FMA lanes, where the 4 x 4 tiles of the first version capped
//     it at half of them;
//   - cp.async: K and V tiles are copied 16 bytes a thread straight into
//     shared memory, each while the other is being used: V(kt) flies
//     during S = Q K(kt)^T, K(kt+1) during the softmax and P V(kt).  A
//     bf16 or float16 tile lands in a staging area and each thread widens
//     the 16-byte pieces it copied itself (__bfloat162float,
//     __half2float), so the float32 path and the half paths wait at the
//     same three barriers a tile; a half output is rounded once
//     (__float2bfloat16, __float2half_rn);
//   - heaviest query tiles first: the grid is (BH, query tiles) with the
//     tile index reversed when causal, so the query tiles that attend to
//     the most key tiles (a global layer's last ones) start in the first
//     wave and do not form the tail;
//   - shared memory: Q (BQ x (d+4)), one K and one V tile (64 x (d+4))
//     and P (BQ x 72) are 106,496 bytes at d = 64 in float32: two blocks
//     an SM, 8 warps.  Row strides are padded so that the 8 lanes of a
//     quarter-warp hit 8 different 16-byte bank groups (d+4 = 4 mod 32
//     banks for K, 72 = 8 mod 32 for P's scalar stores).  At d = 256 the
//     float tiles alone take 175,616 bytes (one block an SM), and two
//     half staging tiles (65,536 bytes) would pass the 232,448 a block
//     may have: there K and V share one staging tile and take turns in
//     it.  V(kt) still flies during S = Q K(kt)^T and the softmax, but
//     K(kt+1) is issued only once V(kt) has been widened, and flies
//     during P V(kt).
// Tensor cores (wgmma in bf16 or 3xTF32) are the later step; they wait on
// the accuracy of the path's large scores (see PERF.md).
//
// Layout of one launch.  A block of 128 threads owns one (bh, BQ-query
// tile), BQ = 16 RM: thread (ty, tx) = (t / 8, t % 8) owns query rows
// ty + 16 i (i < RM), score columns tx + 8 j (j < 8) of each 64-key tile
// and the output columns (c / 4) 32 + 4 tx + c % 4 (c < d/8; 2 tx + c at
// d = 16).  A row's 8 threads are 8 consecutive lanes, so the row max and
// row sum of the online softmax are three shuffles.  Scores are kept in
// log2 units (scaled by d^-1/2 log2(e) in one multiply), the running max
// too, and weights are exp2f of their differences (no fast-math): the same
// function as exp of the natural-unit difference, at the cost of one more
// float32 rounding of the score, and a masked score stays NEG, so the
// skipping argument above holds as it is.
//
// Interface: plain C functions, built with nvcc into a shared library and
// called through ctypes (repro_torch/kernels/flash_attention/kernel.py).
// flash_attention_launch launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().  The
// wrapper's launch_geometry works out the launch shape (threads, query and
// key tile, shared bytes) and passes it in; the entry point checks it
// against the kernel's own constants and refuses any other value.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBk = 64;
constexpr int kLdp = kBk + 8;
constexpr float kNeg = -1073741824.0f;  // -2^30, the TPU kernel's NEG
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  // query rows a thread: 64 outputs a thread at d >= 64
  static constexpr int RM = D == 256 ? 2 : D == 128 ? 4 : 8;
  static constexpr int BQ = 16 * RM;            // query rows a block
  static constexpr int DC = D / 8;              // output columns a thread
  static constexpr int LD = D + 4;              // float row stride of Q, K, V
  static constexpr int MIN_BLOCKS = D >= 128 ? 1 : 2;
  // bfloat16 and float16: 2-byte values staged and widened
  static constexpr bool HALF = sizeof(T) == 2;
  // one half staging tile that K and V take turns in (d = 256), or two
  static constexpr bool ONE_STAGE = HALF && D == 256;
  static constexpr int EPC = 16 / sizeof(T);    // elements in 16 bytes
  static constexpr size_t FLOATS = static_cast<size_t>(BQ) * LD
                                 + 2 * kBk * LD + static_cast<size_t>(BQ) * kLdp;
  static constexpr size_t STAGE =
      HALF ? (ONE_STAGE ? 1 : 2) * kBk * D * sizeof(T) : 0;
  static constexpr size_t SMEM = FLOATS * sizeof(float) + STAGE;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) {
  return __half2float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copy of rows [r0, r0 + 64) of a (rows, D) matrix: float32 rows
// go straight into the (64, D + 4) float tile, bf16 and float16 rows into
// the (64, D) staging tile; rows at or past `rows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void issue_tile(float* tile, T* stage,
                                           const T* src, int r0, int rows) {
  using C = Cfg<T, D>;
  constexpr int PER_ROW = D / C::EPC;
  for (int e = threadIdx.x; e < kBk * PER_ROW; e += kThreads) {
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * C::EPC;
    const int gr = r0 + r;
    const T* g = src + static_cast<long long>(gr < rows ? gr : 0) * D + c;
    void* dst;
    if constexpr (C::HALF) {
      dst = stage + r * D + c;
    } else {
      dst = tile + r * C::LD + c;
    }
    cp_async16(dst, g, gr < rows ? 16 : 0);
  }
}

// bf16 and float16 only: widen the 16-byte pieces this thread copied into
// the float tile (its own cp.async results are visible to it after the
// wait)
template <typename T, int D>
__device__ __forceinline__ void widen_tile(float* tile, const T* stage) {
  using C = Cfg<T, D>;
  if constexpr (C::HALF) {
    constexpr int PER_ROW = D / C::EPC;
    for (int e = threadIdx.x; e < kBk * PER_ROW; e += kThreads) {
      const int r = e / PER_ROW;
      const int c = (e % PER_ROW) * C::EPC;
#pragma unroll
      for (int u = 0; u < C::EPC; ++u) {
        tile[r * C::LD + c + u] = to_float(stage[r * D + c + u]);
      }
    }
  }
}

// output column of the thread's jj-th accumulator
template <int D>
__device__ __forceinline__ int out_col(int tx, int jj) {
  constexpr int DC = D / 8;
  if constexpr (DC >= 4) {
    return (jj / 4) * 32 + tx * 4 + (jj % 4);
  } else {
    return tx * DC + jj;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (Cfg<T, D>::MIN_BLOCKS))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Sq, int Sk, int n_rep, float scale, int causal,
                       int window) {
  using C = Cfg<T, D>;
  constexpr int RM = C::RM;
  constexpr int BQ = C::BQ;
  constexpr int DC = C::DC;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + kBk * LD;
  float* Ps = Vs + kBk * LD;
  T* Kst = reinterpret_cast<T*>(Ps + BQ * kLdp);
  T* Vst = C::ONE_STAGE ? Kst : Kst + kBk * D;

  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * BQ;
  const long long kv_row = bh / n_rep;
  const T* qb = q + static_cast<long long>(bh) * Sq * D;
  const T* kb = k + kv_row * Sk * D;
  const T* vb = v + kv_row * Sk * D;
  const int t = threadIdx.x;
  const int ty = t >> 3;
  const int tx = t & 7;
  // scores in log2 units: exp(s scale - m) = exp2(s scale log2(e) - m')
  const float scale2 = scale * kLog2e;

  // key tiles that hold a key some query of this tile may attend to
  int kt_end = (Sk + kBk - 1) / kBk;
  if (causal) {
    const int last = (q0 + BQ - 1) / kBk + 1;
    if (last < kt_end) kt_end = last;
  }
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;   // the least key a query here may keep
    if (lo > 0) kt_begin = lo / kBk;
  }

  issue_tile<T, D>(Ks, Kst, kb, kt_begin * kBk, Sk);
  cp_async_commit();
  for (int e = t; e < BQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int gr = q0 + r;
    Qs[r * LD + c] = gr < Sq
        ? to_float(qb[static_cast<long long>(gr) * D + c]) : 0.0f;
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBk;
    const bool more = kt + 1 < kt_end;
    cp_async_wait<0>();                  // K(kt)
    widen_tile<T, D>(Ks, Kst);
    __syncthreads();   // K(kt), Q visible; the last tile's P V is done
    issue_tile<T, D>(Vs, Vst, vb, k0, Sk);
    cp_async_commit();

    // s = Q K^T for the thread's RM x 8 scores
    float s[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + c]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * LD + c]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        }
      }
    }
    __syncthreads();   // every reader of Ks is done
    if (more && !C::ONE_STAGE) {
      issue_tile<T, D>(Ks, Kst, kb, k0 + kBk, Sk);
      cp_async_commit();
    }

    // scale, mask and the online softmax, one query row at a time; a tile
    // that the mask keeps whole needs no compares
    const bool whole = (!causal || k0 + kBk - 1 <= q0)
        && (window <= 0 || q0 + BQ - 1 - k0 < window) && k0 + kBk <= Sk;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool ok = true;
        if (!whole) {
          ok = kp < Sk;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && (qp - kp) < window;
        }
        s[i][j] = ok ? s[i][j] * scale2 : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kLdp + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
    }
    if (more && !C::ONE_STAGE) {
      cp_async_wait<1>();                // V(kt); K(kt+1) may fly on
    } else {
      cp_async_wait<0>();
    }
    widen_tile<T, D>(Vs, Vst);
    __syncthreads();   // P and V(kt) visible; the staging tile is free
    if (more && C::ONE_STAGE) {
      issue_tile<T, D>(Ks, Kst, kb, k0 + kBk, Sk);   // flies during P V
      cp_async_commit();
    }

    // acc += P V
#pragma unroll 2
    for (int kk = 0; kk < kBk; kk += 4) {
      float4 pa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kLdp + kk]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = &Vs[(kk + u) * LD];
        float vv[DC];
        if constexpr (DC >= 4) {
#pragma unroll
          for (int h = 0; h < DC / 4; ++h) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(&vrow[h * 32 + tx * 4]);
            vv[4 * h] = w4.x;
            vv[4 * h + 1] = w4.y;
            vv[4 * h + 2] = w4.z;
            vv[4 * h + 3] = w4.w;
          }
        } else {
          const float2 w2 = *reinterpret_cast<const float2*>(&vrow[tx * 2]);
          vv[0] = w2.x;
          vv[1] = w2.y;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                        : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<long long>(bh) * Sq + qp) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      store(&orow[out_col<D>(tx, jj)], acc[i][jj] * inv);
    }
  }
}

// The launch shape the wrapper passes in: threads a block, query rows a
// block, keys a tile, shared bytes a block.
struct Geometry {
  int threads, q_tile, k_tile, smem_bytes;
};

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Sq, int Sk, int n_rep, float scale,
                   int causal, int window, Geometry geo,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  constexpr size_t smem = C::SMEM;
  if (geo.threads != kThreads || geo.q_tile != C::BQ || geo.k_tile != kBk
      || geo.smem_bytes != static_cast<int>(smem)) {
    return cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(BH, n_qt);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, n_rep, scale,
      causal, window);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* out, int BH, int Sq, int Sk, int n_rep,
                     float scale, int causal, int window, Geometry geo,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, stream);
    case 32: return launch<T, 32>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, stream);
    case 64: return launch<T, 64>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, stream);
    case 128: return launch<T, 128>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, stream);
    case 256: return launch<T, 256>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: device pointers of (BH, Sq, d); k, v: (BKV, Sk, d), contiguous,
// k and v 16-byte aligned, BH = BKV * n_rep; dtype 0 = float32, 1 =
// bfloat16, 2 = float16; d in {16, 32, 64, 128, 256}; Sq, Sk >= 1 and,
// when causal or windowed, Sq <= Sk; window 0 = none; scale
// is d^-1/2 rounded to float32 by the caller, as the TPU kernel's Python
// float is; threads, q_tile, k_tile and smem_bytes are the launch shape
// from the wrapper's launch_geometry, refused unless they are the
// kernel's for (d, dtype).  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int d, int n_rep,
                                      int dtype, int causal, int window,
                                      float scale, int threads, int q_tile,
                                      int k_tile, int smem_bytes, int device,
                                      void* stream) {
  if (BH <= 0) return 0;
  if (Sq < 1 || Sk < 1 || (Sq > Sk && (causal || window > 0)) || n_rep < 1
      || BH % n_rep != 0 || window < 0
      || dtype < 0 || dtype > 2
      || reinterpret_cast<uintptr_t>(k) % 16 != 0
      || reinterpret_cast<uintptr_t>(v) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry geo{threads, q_tile, k_tile, smem_bytes};
  switch (dtype) {
    case 0: err = launch_d<float>(d, q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, s); break;
    case 1: err = launch_d<__nv_bfloat16>(d, q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, s); break;
    default: err = launch_d<__half>(d, q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, geo, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
