// Mamba-2 SSD chunk scan for Hopper (sm_90a): the port's kernel for
// src/repro/kernels/ssd_scan/kernel.py::_kernel, the TPU kernel behind
// ssd_scan_bh.
//
// What it computes.  In the model's layout x is (b, S, h, P), dt is
// (b, S, h), A is (h,), B and C are (b, S, g, N), with head hh reading
// group hh / (h / g) (the groups are never broadcast).  x, B and C share
// one type T, float32, bfloat16 or float16, loaded in T and widened in
// registers; y is written in T, rounded once from its float32 sum; dt, A,
// the states and every sum are float32 (the TPU kernel casts x, dt, A, B
// and C to float32 and writes y in x's dtype).  Per
// (batch, head) and per chunk c of Q consecutive positions, with the state
// S_{c-1} (P x N, float32) entering the chunk:
//     cum[i]  = sum_{j <= i} dt[j] A                 (within the chunk)
//     y[i]    = sum_{j <= i} (C[i] . B[j]) exp(cum[i] - cum[j]) dt[j] x[j]
//             + exp(cum[i]) (C[i] . S_{c-1}[p, :])_p
//     S_c     = exp(cum[Q-1]) S_{c-1} + dS_c,
//     dS_c    = sum_j exp(cum[Q-1] - cum[j]) dt[j] x[j] B[j]^T
// which is the TPU kernel's chunk step: the intra-chunk (C B^T * L) @ (x dt),
// the carry-in exp(cum) (C @ S^T) and the state update.  y is written in
// the model's layout, and the state after the last chunk as a second
// output (b, h, P, N): the TPU kernel keeps it in scratch and drops it, the
// model's prefill needs it for its cache.  A ragged last chunk is filled
// with dt = 0 and x = 0 past S: decay 1 and no contribution, so it is exact
// and any S is taken.  An initial state may be given (else zero).
//
// Three passes.  The TPU kernel walks the chunks in order because its grid
// runs in order.  Only the state recurrence needs that order, so it runs
// as three launches on the caller's stream:
//   1. chunk state, one block per (batch, head, chunk, 64 columns of P):
//      dS_c and the chunk's decay exp(cum[Q-1]), into scratch the wrapper
//      allocates (b, h, n_chunks, P, N) and (b, h, n_chunks); two halves
//      of the block sum the two halves of the chunk's rows;
//   2. state passing, one thread per (batch, head, p, n), sequential over
//      the chunks: S_c = decay_c S_{c-1} + dS_c from the initial state (or
//      zero); it overwrites dS_c with S_{c-1}, the state entering chunk c,
//      and writes the last S as the final state;
//   3. chunk scan, one block per (batch, head, chunk, 64 columns of P): y
//      from the chunk's x, dt, B, C and the state entering it.
// At Hymba-1.5B's prefill (b=4, h=50, S=2048, Q=128) passes 1 and 3 have
// 3,200 blocks each, where one block per (batch, head) gave 200.
//
// What bounds it.  Per (batch, head) and chunk, 2 T (N + P) + 4 Q P N
// operations with T = Q (Q+1) / 2 the causal half of the Q x Q tile (the
// scores and their product with x dt, counted over the pairs j <= i; the
// carry-in and the state update over all of Q x P x N): 1.57 MFLOP at
// Q=128, P=64, N=16.  A layer of Hymba-1.5B's prefill is 5.9e9
// operations, 0.088 ms at the float32 rate of 67 TFLOP/s, and 210 MB of
// bytes (x, dt, B, C read once, y and the state written once), 0.063 ms at
// 3.35 TB/s: operations bound it.  (The passes read x twice and move the
// 13 MB of chunk states three times more; the bound does not count that.)
// What the design does about it:
//   - chunk parallel: 16 x more blocks than (batch, head) pairs;
//   - register tiles in pass 3: a thread owns 8 rows x 8 columns of y
//     (64 accumulators) and reads, for each key j, its 8 scores and 8
//     values of x as float2 and float4 loads (64 FMAs for 8 + 2 b floats,
//     b the bands a panel feeds: 4 FMAs a float on the first panel); the
//     scores of a 32-key panel are built by the warp that consumes them, 4
//     rows x 2 keys a lane, so the panel loop needs no block barrier;
//   - causal skipping, balanced: the chunk's rows fall into 32-row bands,
//     and band b reads key panels 0..b only (the diagonal panel's scores
//     above the diagonal are zeros).  Warp w owns rows 8w..8w+7 of every
//     band, so the four warps of a block carry equal shares of the
//     triangle (a warp a band would leave the last band's warp with 4 of
//     the 10 band-panels, and it shares its scheduler with the last warp
//     of every other resident block);
//   - cp.async: the x tile (and pass 1's B rows) are copied 16 bytes a
//     thread straight into shared memory, so a block has all its loads in
//     flight at once; B, C and the entering state come in as float4 and
//     are stored transposed; pass 2 issues the loads of 8 chunks before it
//     walks them.  A half type's x, B and C are loaded by the threads and
//     widened to float as they are stored to shared memory (its bytes are
//     half of float32's, and operations bound the kernel either way);
//   - row strides padded so that float4 accesses of a quarter-warp hit
//     distinct banks; shared memory 71,680 bytes at Q=128, N=16 (3 blocks
//     an SM) and 218,624 at N=128.
// Exponentials are expf (no fast-math).  Tensor cores (bf16 or 3xTF32) are
// the later step, pending the accuracy of the chunk's exp(cum) products.
//
// Interface: plain C functions, built with nvcc into a shared library and
// called through ctypes (repro_torch/kernels/ssd_scan/kernel.py).
// ssd_scan_launch launches the three passes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// The wrapper's launch_geometry works out the passes' launch shape
// (threads, columns of P a block, shared bytes) and passes it in; the
// entry point checks it against its own constants and refuses any other
// value.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStateThreads = 256;   // pass 1: two halves of the chunk's rows
constexpr int kMaxQ = 128;     // chunk length: 4 positions a lane of warp 0
constexpr int kMaxPN = 128;
constexpr int kPT = 64;        // columns of P a block of pass 1 or 3 owns
constexpr int kJ = 32;         // keys of one score panel, rows of one band
constexpr int kPassThreads = 256;   // pass 2
constexpr int kPassBatch = 8;       // chunks whose loads pass 2 issues at once

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// shared floats of pass 1: dt, cum, the decay to the chunk's end, x (QP x
// 64), B (QP x N4), and the second half's partial sums (128 x 8)
__host__ __device__ inline int state_smem_floats(int Q, int N) {
  const int QP = round_up(Q, 32);
  return 3 * QP + QP * kPT + QP * round_up(N, 4) + 8 * kThreads;
}

// shared floats of pass 3: dt, cum, C^T and B^T (N4 x (QP + 4)), x (QP x
// 64), S^T (N4 x 64), one score panel (32 x (QP + 4))
__host__ __device__ inline int scan_smem_floats(int Q, int N) {
  const int QP = round_up(Q, 32);
  const int N4 = round_up(N, 4);
  return 2 * QP + 2 * N4 * (QP + 4) + QP * kPT + N4 * kPT + kJ * (QP + 4);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// 4 consecutive values widened to float: one float4 load for float32 (16-
// byte aligned), 4 loads for a half type
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(to_float(p[0]), to_float(p[1]), to_float(p[2]),
                       to_float(p[3]));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// warp 0: dt of the chunk's positions (0 past nq and up to QP) into dts and
// cum = the inclusive prefix sum of dt A, 4 positions a lane
__device__ __forceinline__ void chunk_cum(const float* __restrict__ dt,
                                          float a, long long row0, int H,
                                          int hh, int nq, int QP, float* dts,
                                          float* cum) {
  const int lane = threadIdx.x;
  float d[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = 4 * lane + u;
    d[u] = j < nq ? dt[(row0 + j) * H + hh] : 0.0f;
  }
  float v[4];
  float run = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = 4 * lane + u;
    if (j < QP) dts[j] = d[u];
    run += j < QP ? d[u] * a : 0.0f;
    v[u] = run;
  }
  float pre = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, pre, off);
    if (lane >= off) pre += o;
  }
  pre -= run;   // exclusive prefix of this lane's 4 positions
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = 4 * lane + u;
    if (j < QP) cum[j] = pre + v[u];
  }
}

// Rows [0, QP) x columns [p0, p0 + 64) of x for one (batch, head, chunk)
// into Xs (QP x 64), zero past nq rows and P columns: 16-byte cp.async
// copies when vec (P % 4 == 0, x 16-byte aligned) and x is float32, else
// loads widened to float.  The caller waits for the copies.
template <typename T>
__device__ __forceinline__ void load_x(float* Xs, const T* __restrict__ x,
                                       long long row0, int H, int hh, int P,
                                       int p0, int nq, int QP, bool vec) {
  if (sizeof(T) == 4 && vec) {
    for (int e = threadIdx.x; e < QP * (kPT / 4); e += blockDim.x) {
      const int j = e / (kPT / 4);
      const int c = 4 * (e % (kPT / 4));
      const bool ok = j < nq && p0 + c < P;
      const T* src = ok ? x + ((row0 + j) * H + hh) * P + p0 + c : x;
      cp_async16(&Xs[j * kPT + c], src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < QP * kPT; e += blockDim.x) {
      const int j = e / kPT;
      const int p = p0 + e % kPT;
      Xs[e] = j < nq && p < P ? to_float(x[((row0 + j) * H + hh) * P + p])
                              : 0.0f;
    }
  }
}

// Pass 1: dS_c[p, n] = sum_j (exp(cum[QP-1] - cum[j]) dt[j]) x[j, p] B[j, n]
// for 64 columns p of one (batch, head, chunk), and the chunk's decay.
// 256 threads: thread t sums rows [0, QP/2) (t < 128) or [QP/2, QP) of
// the 2 p x 4 n tile t % 128, and the first half adds the second's.
template <typename T>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(const T* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const T* __restrict__ B,
                       float* __restrict__ chunk_states,
                       float* __restrict__ chunk_decay, int S, int H, int G,
                       int P, int N, int Q, int nc, int vec_p, int vec_n) {
  extern __shared__ __align__(16) float smem[];
  const int QP = round_up(Q, 32);
  const int N4 = round_up(N, 4);
  float* dts = smem;
  float* cum = dts + QP;
  float* wend = cum + QP;
  float* Xs = wend + QP;
  float* Bs = Xs + QP * kPT;
  float* red = Bs + QP * N4;

  const int bh = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int bb = bh / H;
  const int hh = bh % H;
  const int grp = hh / (H / G);
  const int p0 = blockIdx.y * kPT;
  const int c0 = c * Q;
  const int nq = S - c0 < Q ? S - c0 : Q;   // real rows of this chunk
  const long long row0 = static_cast<long long>(bb) * S + c0;
  const int t = threadIdx.x;

  load_x(Xs, x, row0, H, hh, P, p0, nq, QP, vec_p);
  if (sizeof(T) == 4 && vec_n) {   // N % 4 == 0: B's rows are the shared rows
    for (int e = t; e < QP * (N / 4); e += kStateThreads) {
      const int j = e / (N / 4);
      const int n = 4 * (e % (N / 4));
      const T* src = j < nq ? B + ((row0 + j) * G + grp) * N + n : B;
      cp_async16(&Bs[j * N + n], src, j < nq ? 16 : 0);
    }
  } else {
    for (int e = t; e < QP * N4; e += kStateThreads) {
      const int j = e / N4;
      const int n = e % N4;
      Bs[e] = j < nq && n < N ? to_float(B[((row0 + j) * G + grp) * N + n])
                              : 0.0f;
    }
  }
  if (t < 32) chunk_cum(dt, A[hh], row0, H, hh, nq, QP, dts, cum);
  cp_async_wait_all();
  __syncthreads();
  const float c_end = cum[QP - 1];
  for (int j = t; j < QP; j += kStateThreads) {
    wend[j] = expf(c_end - cum[j]) * dts[j];
  }
  __syncthreads();
  const long long out0 = (static_cast<long long>(bh) * nc + c) * P * N;
  if (t == 0) chunk_decay[static_cast<long long>(bh) * nc + c] = expf(c_end);
  const int n_nt = N4 / 4;
  const int n_tiles = (kPT / 2) * n_nt;
  const int half = t / kThreads;
  const int tl = t % kThreads;
  const int j_lo = half * (QP / 2);
  const int j_hi = min(nq, j_lo + QP / 2);
  for (int base = 0; base < n_tiles; base += kThreads) {   // same trip count
    const int e = base + tl;                                // for every thread
    const int pt = e / n_nt;
    const int nt = e % n_nt;
    const bool ok = e < n_tiles && p0 + 2 * pt < P;
    float acc[2][4] = {};
    if (ok) {
#pragma unroll 4
      for (int j = j_lo; j < j_hi; ++j) {
        const float w = wend[j];
        const float2 xv = *reinterpret_cast<const float2*>(&Xs[j * kPT + 2 * pt]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[j * N4 + 4 * nt]);
        const float x0 = w * xv.x;
        const float x1 = w * xv.y;
        acc[0][0] = fmaf(x0, bv.x, acc[0][0]);
        acc[0][1] = fmaf(x0, bv.y, acc[0][1]);
        acc[0][2] = fmaf(x0, bv.z, acc[0][2]);
        acc[0][3] = fmaf(x0, bv.w, acc[0][3]);
        acc[1][0] = fmaf(x1, bv.x, acc[1][0]);
        acc[1][1] = fmaf(x1, bv.y, acc[1][1]);
        acc[1][2] = fmaf(x1, bv.z, acc[1][2]);
        acc[1][3] = fmaf(x1, bv.w, acc[1][3]);
      }
    }
    if (half == 1) {
#pragma unroll
      for (int u = 0; u < 8; ++u) red[u * kThreads + tl] = acc[u / 4][u % 4];
    }
    __syncthreads();
    if (half == 0 && ok) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + 2 * pt + u;
        if (p >= P) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int n = 4 * nt + v;
          if (n < N) {
            chunk_states[out0 + static_cast<long long>(p) * N + n] =
                acc[u][v] + red[(4 * u + v) * kThreads + tl];
          }
        }
      }
    }
    __syncthreads();   // before the next tiles overwrite red
  }
}

// Pass 2: for each (batch, head, p, n), S_c = decay_c S_{c-1} + dS_c from
// the initial state; dS_c is replaced by S_{c-1}, the last S goes to
// state_out.  The loads of kPassBatch chunks are issued before the
// recurrence walks them.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ chunk_states,
                      const float* __restrict__ chunk_decay,
                      const float* __restrict__ init_state,
                      float* __restrict__ state_out, long long BH, int PN,
                      int nc) {
  const long long e = static_cast<long long>(blockIdx.x) * kPassThreads
                    + threadIdx.x;
  if (e >= BH * PN) return;
  const long long bh = e / PN;
  const int i = static_cast<int>(e % PN);
  float s = init_state ? init_state[e] : 0.0f;
  float* cs = chunk_states + bh * nc * PN + i;
  const float* dc = chunk_decay + bh * nc;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float d[kPassBatch], a[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      const bool ok = c0 + u < nc;
      d[u] = ok ? cs[static_cast<long long>(c0 + u) * PN] : 0.0f;
      a[u] = ok ? dc[c0 + u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < nc) {
        cs[static_cast<long long>(c0 + u) * PN] = s;
        s = a[u] * s + d[u];
      }
    }
  }
  state_out[e] = s;
}

// Pass 3: y of one (batch, head, chunk) for 64 columns of P.  The padded
// chunk's rows fall into NB = QP / 32 bands of 32; band b needs the key
// panels 0..b.  Warp w owns rows 32 b + 8 w .. + 7 of every band, so the
// four warps carry the same share of the causal triangle.  Lane (r, c) =
// (lane / 8, lane % 8) owns rows 32 b + 8 w + 2 r + {0, 1} of each band b
// and columns 4 c + {0..3}, 32 + 4 c + {0..3}: 8 rows x 8 columns.  Rows
// past nq compute zeros (their C and dt are zero) and are not stored.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_scan_kernel(const T* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const T* __restrict__ B,
                      const T* __restrict__ C,
                      const float* __restrict__ chunk_states,
                      T* __restrict__ y, int S, int H, int G, int P,
                      int N, int Q, int nc, int vec_p, int vec_n) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QP = NB * kJ;
  constexpr int LQ = QP + 4;
  const int N4 = round_up(N, 4);
  float* dts = smem;
  float* cum = dts + QP;
  float* Ct = cum + QP;            // Ct[n * LQ + i] = C[i, n]
  float* Bt = Ct + N4 * LQ;        // Bt[n * LQ + j] = B[j, n]
  float* Xs = Bt + N4 * LQ;        // Xs[j * 64 + p] = x[j, p0 + p]
  float* Sts = Xs + QP * kPT;      // Sts[n * 64 + p] = S_{c-1}[p0 + p, n]
  float* Gt = Sts + N4 * kPT;      // Gt[jj * LQ + i] = G[i, j0 + jj]

  const int bh = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int bb = bh / H;
  const int hh = bh % H;
  const int grp = hh / (H / G);
  const int p0 = blockIdx.y * kPT;
  const int c0 = c * Q;
  const int nq = S - c0 < Q ? S - c0 : Q;
  const long long row0 = static_cast<long long>(bb) * S + c0;
  const int t = threadIdx.x;
  const int w = t >> 5;
  const int lane = t & 31;

  load_x(Xs, x, row0, H, hh, P, p0, nq, QP, vec_p);
  if (t < 32) chunk_cum(dt, A[hh], row0, H, hh, nq, QP, dts, cum);
  const float* st = chunk_states + (static_cast<long long>(bh) * nc + c) * P * N;
  if (vec_n) {   // N % 4 == 0: rows of B, C and the state 4 at a time
    const int n4 = N / 4;
#pragma unroll 4
    for (int e = t; e < QP * n4; e += kThreads) {
      const int j = e / n4;
      const int n = 4 * (e % n4);
      float4 cv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 bv = cv;
      if (j < nq) {
        const long long g = ((row0 + j) * G + grp) * N + n;
        cv = load4(&C[g]);
        bv = load4(&B[g]);
      }
      Ct[n * LQ + j] = cv.x;
      Ct[(n + 1) * LQ + j] = cv.y;
      Ct[(n + 2) * LQ + j] = cv.z;
      Ct[(n + 3) * LQ + j] = cv.w;
      Bt[n * LQ + j] = bv.x;
      Bt[(n + 1) * LQ + j] = bv.y;
      Bt[(n + 2) * LQ + j] = bv.z;
      Bt[(n + 3) * LQ + j] = bv.w;
    }
#pragma unroll 4
    for (int e = t; e < kPT * n4; e += kThreads) {
      const int p = e / n4;
      const int n = 4 * (e % n4);
      float4 sv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p0 + p < P) {
        sv = *reinterpret_cast<const float4*>(
            &st[static_cast<long long>(p0 + p) * N + n]);
      }
      Sts[n * kPT + p] = sv.x;
      Sts[(n + 1) * kPT + p] = sv.y;
      Sts[(n + 2) * kPT + p] = sv.z;
      Sts[(n + 3) * kPT + p] = sv.w;
    }
  } else {
    for (int e = t; e < QP * N4; e += kThreads) {
      const int j = e / N4;
      const int n = e % N4;
      const bool ok = j < nq && n < N;
      const long long g = ((row0 + j) * G + grp) * N + n;
      Ct[n * LQ + j] = ok ? to_float(C[g]) : 0.0f;
      Bt[n * LQ + j] = ok ? to_float(B[g]) : 0.0f;
    }
    for (int e = t; e < kPT * N4; e += kThreads) {
      const int p = e / N4;
      const int n = e % N4;
      Sts[n * kPT + p] = p0 + p < P && n < N
          ? st[static_cast<long long>(p0 + p) * N + n] : 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int r0 = 8 * w + 2 * (lane >> 3); // + 32 b: the lane's row pairs
  const int cg = 4 * (lane & 7);          // its columns cg, 32 + cg
  float acc[NB][2][8];

  // carry-in: acc = exp(cum[i]) (C[i] . S[p, :])
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[b][u][k] = 0.0f;
    }
  }
#pragma unroll 2
  for (int n = 0; n < N; ++n) {
    const float4 b0 = *reinterpret_cast<const float4*>(&Sts[n * kPT + cg]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Sts[n * kPT + 32 + cg]);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float2 a = *reinterpret_cast<const float2*>(&Ct[n * LQ + 32 * b + r0]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[b][0][k] = fmaf(a.x, bv[k], acc[b][0][k]);
        acc[b][1][k] = fmaf(a.y, bv[k], acc[b][1][k]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float e = expf(cum[32 * b + r0 + u]);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[b][u][k] *= e;
    }
  }

  // the causal part: panel pn (keys 32 pn ..) feeds bands pn .. NB - 1
  const int gr = 8 * w + 4 * (lane >> 4);   // + 32 b: the lane's 4 score rows
  const int gk = lane & 15;                 // its keys j0 + gk, j0 + gk + 16
#pragma unroll
  for (int pn = 0; pn < NB; ++pn) {
    const int j0 = kJ * pn;
    const int ka = j0 + gk;
    const int kb = ka + 16;
    const float cka = cum[ka], ckb = cum[kb];
    const float dka = dts[ka], dkb = dts[kb];
    // G[i, j] = (C[i] . B[j]) exp(cum[i] - cum[j]) dt[j] for j <= i, for
    // the warp's rows of the bands this panel feeds, two bands at a time
    // so that each key loaded feeds 8 FMAs
#pragma unroll
    for (int b = pn; b < NB; b += 2) {
      constexpr int kMaxPair = 2;
      const int nbands = b + 1 < NB ? 2 : 1;
      float g[kMaxPair][4][2];
#pragma unroll
      for (int q = 0; q < kMaxPair; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) g[q][r][0] = g[q][r][1] = 0.0f;
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float k0 = Bt[n * LQ + ka];
        const float k1 = Bt[n * LQ + kb];
#pragma unroll
        for (int q = 0; q < kMaxPair; ++q) {
          if (q < nbands) {
            const float4 a = *reinterpret_cast<const float4*>(
                &Ct[n * LQ + 32 * (b + q) + gr]);
            const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              g[q][r][0] = fmaf(av[r], k0, g[q][r][0]);
              g[q][r][1] = fmaf(av[r], k1, g[q][r][1]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kMaxPair; ++q) {
        if (q < nbands) {
          const int i0 = 32 * (b + q) + gr;
          float o0[4], o1[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            const float ci = cum[i];
            o0[r] = ka <= i ? g[q][r][0] * expf(ci - cka) * dka : 0.0f;
            o1[r] = kb <= i ? g[q][r][1] * expf(ci - ckb) * dkb : 0.0f;
          }
          *reinterpret_cast<float4*>(&Gt[gk * LQ + i0]) =
              make_float4(o0[0], o0[1], o0[2], o0[3]);
          *reinterpret_cast<float4*>(&Gt[(gk + 16) * LQ + i0]) =
              make_float4(o1[0], o1[1], o1[2], o1[3]);
        }
      }
    }
    __syncwarp();   // the panel's scores of the warp's rows are written
#pragma unroll 4
    for (int jj = 0; jj < kJ; ++jj) {
      const float4 x0 = *reinterpret_cast<const float4*>(&Xs[(j0 + jj) * kPT + cg]);
      const float4 x1 = *reinterpret_cast<const float4*>(&Xs[(j0 + jj) * kPT + 32 + cg]);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int b = pn; b < NB; ++b) {
        const float2 a = *reinterpret_cast<const float2*>(&Gt[jj * LQ + 32 * b + r0]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc[b][0][k] = fmaf(a.x, xv[k], acc[b][0][k]);
          acc[b][1][k] = fmaf(a.y, xv[k], acc[b][1][k]);
        }
      }
    }
    __syncwarp();   // before the next panel overwrites Gt
  }

#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 32 * b + r0 + u;
      if (i >= nq) continue;
      T* yrow = y + ((row0 + i) * H + hh) * P;
      if (sizeof(T) == 4 && vec_p) {   // P % 4 == 0: runs of 4 in or out
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int p = p0 + 32 * h2 + cg;
          if (p < P) {
            float* yf = reinterpret_cast<float*>(yrow) + p;   // T is float
            *reinterpret_cast<float4*>(yf) = make_float4(
                acc[b][u][4 * h2], acc[b][u][4 * h2 + 1],
                acc[b][u][4 * h2 + 2], acc[b][u][4 * h2 + 3]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int p = p0 + (k < 4 ? cg + k : 32 + cg + k - 4);
          if (p < P) store(&yrow[p], acc[b][u][k]);
        }
      }
    }
  }
}

template <typename T, int NB>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t s,
                        const void* x, const void* dt, const void* A,
                        const void* B, const void* C,
                        const void* chunk_states, void* y, int S, int H,
                        int G, int P, int N, int Q, int nc, int vec_p,
                        int vec_n) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T, NB><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(chunk_states),
      static_cast<T*>(y), S, H, G, P, N, Q, nc, vec_p, vec_n);
  return cudaGetLastError();
}

// the three passes for x, B, C and y of type T
template <typename T>
cudaError_t launch_all(cudaStream_t s, const void* x, const void* dt,
                       const void* A, const void* B, const void* C,
                       const void* init_state, void* y, void* state_out,
                       void* chunk_states, void* chunk_decay, long long BH,
                       int S, int H, int G, int P, int N, int Q, int nc,
                       size_t smem1, size_t smem3, int vec_p, int vec_n) {
  cudaError_t err;
  if (nc > 0) {
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(BH * nc), (P + kPT - 1) / kPT);
    ssd_chunk_state_kernel<T><<<grid, kStateThreads, smem1, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(B),
        static_cast<float*>(chunk_states), static_cast<float*>(chunk_decay),
        S, H, G, P, N, Q, nc, vec_p, vec_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long elems = BH * P * N;
  ssd_state_pass_kernel<<<static_cast<unsigned>((elems + kPassThreads - 1) / kPassThreads),
                          kPassThreads, 0, s>>>(
      static_cast<float*>(chunk_states), static_cast<const float*>(chunk_decay),
      static_cast<const float*>(init_state), static_cast<float*>(state_out),
      BH, P * N, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return err;
  const dim3 grid(static_cast<unsigned>(BH * nc), (P + kPT - 1) / kPT);
  switch (round_up(Q, kJ) / kJ) {
    case 1: return launch_scan<T, 1>(grid, smem3, s, x, dt, A, B, C, chunk_states, y, S, H, G, P, N, Q, nc, vec_p, vec_n);
    case 2: return launch_scan<T, 2>(grid, smem3, s, x, dt, A, B, C, chunk_states, y, S, H, G, P, N, Q, nc, vec_p, vec_n);
    case 3: return launch_scan<T, 3>(grid, smem3, s, x, dt, A, B, C, chunk_states, y, S, H, G, P, N, Q, nc, vec_p, vec_n);
    default: return launch_scan<T, 4>(grid, smem3, s, x, dt, A, B, C, chunk_states, y, S, H, G, P, N, Q, nc, vec_p, vec_n);
  }
}

}  // namespace

// x, y: device pointers of (b, S, h, P); dt: (b, S, h); A: (h,); B, C:
// (b, S, g, N); init_state (or null) and state_out: (b, h, P, N);
// chunk_states (b, h, n_chunks, P, N) and chunk_decay (b, h, n_chunks)
// scratch, n_chunks = ceil(S / Q); all contiguous; x, B, C and y of the
// type dtype (0 = float32, 1 = bfloat16, 2 = float16), dt, A, the states
// and the scratch float32; h % g == 0; P, N <= 128; 1 <= Q <= 128.
// state_threads, scan_threads, pass_threads, p_tile, state_smem and
// scan_smem are the launch shape from the wrapper's launch_geometry
// (threads a block of pass 1, 3 and 2, columns of P a block of pass 1 and
// 3, shared bytes a block of pass 1 and 3), refused unless they are the
// kernels' own for (P, N, Q).  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C,
                               const void* init_state, void* y,
                               void* state_out, void* chunk_states,
                               void* chunk_decay, int b, int S, int H, int G,
                               int P, int N, int Q, int dtype,
                               int state_threads, int scan_threads,
                               int pass_threads, int p_tile, int state_smem,
                               int scan_smem, int device, void* stream) {
  if (b <= 0 || H <= 0) return 0;
  if (S < 0 || G < 1 || H % G != 0 || P < 1 || P > kMaxPN || N < 1
      || N > kMaxPN || Q < 1 || Q > kMaxQ || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem1_floats = state_smem_floats(Q, N);
  const int smem3_floats = scan_smem_floats(Q, N);
  if (state_threads != kStateThreads || scan_threads != kThreads
      || pass_threads != kPassThreads || p_tile != kPT
      || state_smem != smem1_floats * static_cast<int>(sizeof(float))
      || scan_smem != smem3_floats * static_cast<int>(sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long BH = static_cast<long long>(b) * H;
  const int nc = (S + Q - 1) / Q;
  if (BH * nc > 2147483647LL || (nc > 0 && (!chunk_states || !chunk_decay))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float32 rows 16 bytes at a time: x's and y's when P % 4 == 0, B's and
  // C's when N % 4 == 0, given 16-byte aligned bases (the wrapper's tensors
  // are); the states' rows when N % 4 == 0; a half type's B and C rows are
  // read 4 values at a time whatever their alignment
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_p = P % 4 == 0 && al(x) && al(y);
  const int vec_n = N % 4 == 0 && al(chunk_states)
      && (dtype != 0 || (al(B) && al(C)));
  const size_t smem1 = static_cast<size_t>(smem1_floats) * sizeof(float);
  const size_t smem3 = static_cast<size_t>(smem3_floats) * sizeof(float);
  switch (dtype) {
    case 0: err = launch_all<float>(s, x, dt, A, B, C, init_state, y, state_out, chunk_states, chunk_decay, BH, S, H, G, P, N, Q, nc, smem1, smem3, vec_p, vec_n); break;
    case 1: err = launch_all<__nv_bfloat16>(s, x, dt, A, B, C, init_state, y, state_out, chunk_states, chunk_decay, BH, S, H, G, P, N, Q, nc, smem1, smem3, vec_p, vec_n); break;
    default: err = launch_all<__half>(s, x, dt, A, B, C, init_state, y, state_out, chunk_states, chunk_decay, BH, S, H, G, P, N, Q, nc, smem1, smem3, vec_p, vec_n); break;
  }
  return static_cast<int>(err);
}
