// Flash attention for Hopper (sm_90a): the port's kernel for
// src/repro/kernels/flash_attention/kernel.py::_kernel, the TPU kernel
// behind flash_attention_bhsd.
//
// What it computes.  q is (BH, Sq, d), k and v are (BKV, Sk, d), row-major,
// float32 or bfloat16; BH = BKV * n_rep and query row bh reads kv row
// bh / n_rep (grouped-query attention; the repeat is never materialised).
// With positions 0.. on both sides (prefill and full forward):
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
// first valid key arrives.  Every query has a valid key (its own position,
// because Sq <= Sk, which the wrapper requires), so every row sees one.
// Keys at or past Sk (the ragged last tile) and queries at or past Sq are
// masked the same way, so any length is taken.
//
// What bounds it.  4*d operations for every query-key pair the mask keeps
// (QK^T and PV, one FMA = 2 operations each), in float32 FMA outside the
// tensor cores: 67 TFLOP/s on an H100 SXM.  At Hymba-1.5B's prefill (B=4,
// 25 query heads, S=2048, d=64) a window-1024 layer keeps 4.0e10
// operations' worth of pairs (0.60 ms) and a global layer 5.4e10
// (0.80 ms); its bytes (q, k, v read once, out written once, 126 MB) take
// 0.04 ms, so operations bound it.  What the design does about that: each
// thread keeps a 4x4 tile of scores and a 4 x d/16 tile of the output in
// registers and reads its operands from shared memory as float4 (8 FMAs a
// shared load), row strides padded by 4 floats so that the 8 threads of a
// quarter-warp hit 8 different bank groups.  Tensor cores (wgmma) are the
// later step.
//
// Layout of one launch.  A block of 256 threads owns one (bh, 64-query
// tile): thread (ty, tx) = (t / 16, t % 16) owns query rows ty + 16 i
// (i < 4), score columns tx + 16 j (j < 4) and d/16 output columns.  A row's
// 16 threads are 16 consecutive lanes of one warp, so the row max and row
// sum of the online softmax are shuffles.  Q, the current K and V tiles
// and the probability tile live in shared memory: 64 x (d+4) floats each
// for Q, K, V and 64 x 68 for P, 69,632 bytes at d=64 and 118,784 at
// d=128, past the 48 KB default (cudaFuncSetAttribute).  Exponentials are
// expf (no fast-math), so a score's weight agrees with the plain version
// to float32 rounding.
//
// Interface: one plain C function, built with nvcc into a shared library
// and called through ctypes (repro_torch/kernels/flash_attention/
// kernel.py).  It launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;
constexpr int kLdp = kBk + 4;
constexpr float kNeg = -1073741824.0f;  // -2^30, the TPU kernel's NEG

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(3 * 64 * (D + 4) + 64 * kLdp) * sizeof(float);
}

// rows [r0, r0 + 64) of a (rows, D) matrix into a (64, D + 4) float tile,
// zero past the last row; consecutive threads read consecutive elements
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows) {
  constexpr int LD = D + 4;
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int gr = r0 + r;
    dst[r * LD + c] = gr < rows
        ? to_float(src[static_cast<long long>(gr) * D + c]) : 0.0f;
  }
}

// output column of the thread's jj-th accumulator: float4 runs of 4
// columns for d >= 64, consecutive columns for d = 16 and 32
template <int D>
__device__ __forceinline__ int out_col(int tx, int jj) {
  constexpr int DC = D / 16;
  if constexpr (DC >= 4) {
    return (jj / 4) * 64 + tx * 4 + (jj % 4);
  } else {
    return tx * DC + jj;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Sq, int Sk, int n_rep, float scale, int causal,
                       int window) {
  constexpr int LD = D + 4;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBq * LD;
  float* Vs = Ks + kBk * LD;
  float* Ps = Vs + kBk * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const long long kv_row = bh / n_rep;
  const T* qb = q + static_cast<long long>(bh) * Sq * D;
  const T* kb = k + kv_row * Sk * D;
  const T* vb = v + kv_row * Sk * D;
  const int t = threadIdx.x;
  const int ty = t >> 4;
  const int tx = t & 15;

  load_tile<T, D>(Qs, qb, q0, Sq);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.0f;
  }

  // key tiles that hold a key some query of this tile may attend to
  int kt_end = (Sk + kBk - 1) / kBk;
  if (causal) {
    const int last = (q0 + kBq - 1) / kBk + 1;
    if (last < kt_end) kt_end = last;
  }
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;   // the least key a query here may keep
    if (lo > 0) kt_begin = lo / kBk;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();   // the previous tile's readers of Ks, Vs, Ps are done
    load_tile<T, D>(Ks, kb, k0, Sk);
    load_tile<T, D>(Vs, vb, k0, Sk);
    __syncthreads();

    // s = Q K^T for the thread's 4 x 4 scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + c]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
      }
    }

    // scale, mask and the online softmax, one query row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Sk;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int kk = 0; kk < kBk; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
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
                *reinterpret_cast<const float4*>(&vrow[h * 64 + tx * 4]);
            vv[4 * h] = w4.x;
            vv[4 * h + 1] = w4.y;
            vv[4 * h + 2] = w4.z;
            vv[4 * h + 3] = w4.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < DC; ++jj) vv[jj] = vrow[tx * DC + jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                        : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Sq, int Sk, int n_rep, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBq - 1) / kBq, BH);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, n_rep, scale,
      causal, window);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* out, int BH, int Sq, int Sk, int n_rep,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: device pointers of (BH, Sq, d); k, v: (BKV, Sk, d), contiguous,
// BH = BKV * n_rep; dtype 0 = float32, 1 = bfloat16; d in {16, 32, 64, 128};
// 1 <= Sq <= Sk; window 0 = none; scale is d^-1/2 rounded to float32 by
// the caller, as the TPU kernel's Python float is.  Returns a cudaError_t
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Sq, int Sk, int d, int n_rep,
                                      int dtype, int causal, int window,
                                      float scale, int device,
                                      void* stream) {
  if (BH <= 0) return 0;
  if (Sq < 1 || Sq > Sk || n_rep < 1 || BH % n_rep != 0 || window < 0
      || BH > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
      ? launch_d<float>(d, q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, s)
      : launch_d<__nv_bfloat16>(d, q, k, v, out, BH, Sq, Sk, n_rep, scale, causal, window, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
