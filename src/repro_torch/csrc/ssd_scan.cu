// Mamba-2 SSD chunk scan for Hopper (sm_90a): the port's kernel for
// src/repro/kernels/ssd_scan/kernel.py::_kernel, the TPU kernel behind
// ssd_scan_bh.
//
// What it computes.  In the model's layout x is (b, S, h, P), dt is
// (b, S, h), A is (h,), B and C are (b, S, g, N), all float32, with head hh
// reading group hh / (h / g) (the groups are never broadcast).  Per
// (batch, head) and per chunk of Q consecutive positions, with the state
// St (P x N, float32) entering the chunk:
//     cum[i]  = sum_{j <= i} dt[j] A                 (within the chunk)
//     y[i]    = sum_{j <= i} (C[i] . B[j]) exp(cum[i] - cum[j]) dt[j] x[j]
//             + exp(cum[i]) (C[i] . St[p, :])_p
//     St     <- exp(cum[Q-1]) St + sum_j exp(cum[Q-1] - cum[j]) dt[j] x[j] B[j]^T
// which is the TPU kernel's chunk step: the intra-chunk (C B^T * L) @ (x dt),
// the carry-in exp(cum) (C @ St^T) and the state update.  y is written in
// the model's layout, and the state after the last chunk as a second
// output (b, h, P, N): the TPU kernel keeps it in scratch and drops it, the
// model's prefill needs it for its cache.  A ragged last chunk is filled
// with dt = 0 and x = 0 past S: decay 1 and no contribution, so it is exact
// and any S is taken.  An initial state may be given (else zero).
//
// What bounds it.  Per (batch, head) and chunk, 2 Q^2 N + 2 Q^2 P + 4 Q P N
// operations (the scores, their product with x dt, the carry-in and the
// state update, counted over the full Q x Q tile as the TPU kernel does):
// 3.15 MFLOP at Q=128, P=64, N=16.  At Hymba-1.5B's prefill (b=4, h=50,
// S=2048) a layer is 1.0e10 operations, 0.15 ms at the float32 rate of
// 67 TFLOP/s, and 210 MB of bytes (x, dt, B, C read once, y and the state
// written once), 0.06 ms at 3.35 TB/s: operations bound it.  The chunks
// are sequential; the parallelism is b*h blocks (200 there) and the
// threads of a block.  What the design does: every operand of a chunk is
// read from device memory once into shared memory, the row strides of B
// and St are padded by one float so that a warp's column reads hit 32
// banks, and the Q x Q tile is built 16 rows at a time, so that shared
// memory stays at 56 KB at P=64, N=16 (four blocks an SM) and 210 KB at
// P=N=128.  Its inner loops are scalar FMAs on shared operands; register
// tiling and tensor cores are the later steps.
//
// Layout of one launch.  One block of 256 threads per (batch, head), in a
// loop over the chunks.  Warp 0 computes cum with a warp scan (4 positions
// a lane); then, 16 rows at a time, the threads build G = (C B^T) * L for
// those rows and y = G (x dt) + exp(cum) C St^T; then each thread updates
// its (p, n) entries of St.  Exponentials are expf (no fast-math).
//
// Interface: one plain C function, built with nvcc into a shared library
// and called through ctypes (repro_torch/kernels/ssd_scan/kernel.py).  It
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;      // rows of the Q x Q tile built at a time
constexpr int kMaxQ = 128;     // chunk length: 4 positions a lane of warp 0
constexpr int kMaxPN = 128;

// shared memory of one block, in floats
__host__ __device__ inline int smem_floats(int Q, int P, int N) {
  return P * (N + 1)          // St
       + Q * P                // x dt
       + Q * (N + 1)          // B
       + 3 * Q                // dt, cum, decay to the chunk's end
       + kRows * (N + 1)      // C rows of the tile
       + kRows * Q;           // G rows of the tile
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C,
                const float* __restrict__ init_state,
                float* __restrict__ y, float* __restrict__ state_out,
                int S, int H, int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int NP = N + 1;
  float* St = smem;
  float* Xd = St + P * NP;
  float* Bs = Xd + Q * P;
  float* dts = Bs + Q * NP;
  float* cum = dts + Q;
  float* wend = cum + Q;
  float* Cs = wend + Q;
  float* Gs = Cs + kRows * NP;

  const int bb = blockIdx.x / H;
  const int hh = blockIdx.x % H;
  const int grp = hh / (H / G);
  const int t = threadIdx.x;
  const float a = A[hh];
  const long long sh = static_cast<long long>(blockIdx.x) * P * N;

  for (int e = t; e < P * N; e += kThreads) {
    St[(e / N) * NP + e % N] = init_state ? init_state[sh + e] : 0.0f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int nq = S - c0 < Q ? S - c0 : Q;   // real rows of this chunk
    const long long row0 = static_cast<long long>(bb) * S + c0;
    __syncthreads();   // the previous chunk's readers are done
    for (int j = t; j < Q; j += kThreads) {
      dts[j] = j < nq ? dt[(row0 + j) * H + hh] : 0.0f;
    }
    for (int e = t; e < Q * N; e += kThreads) {
      const int j = e / N;
      const int n = e % N;
      Bs[j * NP + n] = j < nq ? B[((row0 + j) * G + grp) * N + n] : 0.0f;
    }
    __syncthreads();
    for (int e = t; e < Q * P; e += kThreads) {
      const int j = e / P;
      const int p = e % P;
      Xd[e] = j < nq ? x[((row0 + j) * H + hh) * P + p] * dts[j] : 0.0f;
    }
    if (t < 32) {   // cum = inclusive prefix sum of dt A, 4 positions a lane
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * t + u;
        run += j < Q ? dts[j] * a : 0.0f;
        v[u] = run;
      }
      float pre = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, off);
        if (t >= off) pre += o;
      }
      pre -= run;   // exclusive prefix of this lane's 4 positions
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * t + u;
        if (j < Q) cum[j] = pre + v[u];
      }
    }
    __syncthreads();
    const float c_end = cum[Q - 1];
    for (int j = t; j < Q; j += kThreads) wend[j] = expf(c_end - cum[j]);

    for (int r0 = 0; r0 < nq; r0 += kRows) {
      const int jmax = r0 + kRows < Q ? r0 + kRows : Q;
      for (int e = t; e < kRows * N; e += kThreads) {
        const int i = e / N;
        const int n = e % N;
        Cs[i * NP + n] = r0 + i < nq
            ? C[((row0 + r0 + i) * G + grp) * N + n] : 0.0f;
      }
      __syncthreads();
      // G[i, j] = (C[r0+i] . B[j]) exp(cum[r0+i] - cum[j]) for j <= r0+i
      for (int e = t; e < kRows * jmax; e += kThreads) {
        const int i = e / jmax;
        const int j = e % jmax;
        const int r = r0 + i;
        float g = 0.0f;
        if (j <= r && r < Q) {
          float d = 0.0f;
          for (int n = 0; n < N; ++n) d = fmaf(Cs[i * NP + n], Bs[j * NP + n], d);
          g = d * expf(cum[r] - cum[j]);
        }
        Gs[i * Q + j] = g;
      }
      __syncthreads();
      for (int e = t; e < kRows * P; e += kThreads) {
        const int i = e / P;
        const int p = e % P;
        const int r = r0 + i;
        if (r >= nq) continue;
        float diag = 0.0f;
        for (int j = 0; j <= r; ++j) diag = fmaf(Gs[i * Q + j], Xd[j * P + p], diag);
        float off = 0.0f;
        for (int n = 0; n < N; ++n) off = fmaf(Cs[i * NP + n], St[p * NP + n], off);
        y[((row0 + r) * H + hh) * P + p] = diag + expf(cum[r]) * off;
      }
      __syncthreads();   // before the next rows overwrite Cs and Gs
    }

    // St <- exp(cum[Q-1]) St + sum_j wend[j] Xd[j]^T B[j]
    const float decay = expf(c_end);
    for (int e = t; e < P * N; e += kThreads) {
      const int p = e / N;
      const int n = e % N;
      float acc = 0.0f;
      for (int j = 0; j < nq; ++j) {
        acc = fmaf(wend[j] * Xd[j * P + p], Bs[j * NP + n], acc);
      }
      St[p * NP + n] = decay * St[p * NP + n] + acc;
    }
  }
  __syncthreads();
  for (int e = t; e < P * N; e += kThreads) {
    state_out[sh + e] = St[(e / N) * NP + e % N];
  }
}

}  // namespace

// x, y: device pointers of (b, S, h, P); dt: (b, S, h); A: (h,); B, C:
// (b, S, g, N); init_state (or null) and state_out: (b, h, P, N); all
// float32 and contiguous; h % g == 0; P, N <= 128; 1 <= Q <= 128.
// Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C,
                               const void* init_state, void* y,
                               void* state_out, int b, int S, int H, int G,
                               int P, int N, int Q, int device,
                               void* stream) {
  if (b <= 0 || H <= 0) return 0;
  if (S < 0 || G < 1 || H % G != 0 || P < 1 || P > kMaxPN || N < 1
      || N > kMaxPN || Q < 1 || Q > kMaxQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(smem_floats(Q, P, N)) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ssd_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<<<b * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(init_state),
      static_cast<float*>(y), static_cast<float*>(state_out), S, H, G, P, N,
      Q);
  return static_cast<int>(cudaGetLastError());
}
