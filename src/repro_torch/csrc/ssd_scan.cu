// SSD blocked scan for Hopper (sm_90a): the Mamba-2 state-space-duality
// scan of one prefill, for every (batch row, head), from a zero state.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py. It computes the same function: per head
// h, with the (P, N) state carried across chunks of steps,
//   y[q]   = sum_{k<=q} exp(a_cum[q] - a_cum[k]) (C[q].B[k]) x[k]
//            + exp(a_cum[q]) C[q].state
//   state' = exp(a_cum[Q-1]) state + sum_k exp(a_cum[Q-1] - a_cum[k]) x[k] B[k]^T
// with a_cum the running sum of the log decays a over the chunk. The TPU
// kernel's sequential chunk grid axis becomes a loop inside one block, and
// the state lives in that block's shared memory for the whole loop, so it
// never goes through device memory between chunks.
//
// Chunking: the block walks the steps in sub-chunks of kQ = 64. The SSD
// decomposition is exact for any chunk length, so the result is the
// reference's at any `chunk` up to f32 rounding; a TPU chunk of 256
// (mamba2's `ssm_chunk`) would need a 256 x 256 score tile, which does not
// fit in shared memory beside the state. A ragged last sub-chunk is masked
// (zero a, B, C and x: a decay of 1 and no input, so it is inert).
//
// Bound: operations. A sub-chunk does Q^2 N + Q^2 P + 2 Q P N
// multiply-adds per head for Q (P + 2 N) loaded values, far above the
// card's f32 operations-per-byte ratio at P = 64, N = 128. This first
// version does them as plain f32 FMA loops from shared memory on register
// micro-tiles of a 16 x 16 thread grid; C.B^T is recomputed by every head
// of a batch row (sharing it across heads, and moving the products onto
// the tensor cores, are the next steps for speed).
//
// Layout, all f32 and contiguous: x (B, T, H, P) dt-preweighted, a
// (B, T, H) log decays (<= 0, so every exponent is <= 0), Bm / Cm
// (B, T, N) (one group), y (B, T, H, P), state (B, H, P, N).
// Grid: (H, B), one block per (head, batch row). Shared memory: ~130 KB at
// P = 64, N = 128, set through cudaFuncAttributeMaxDynamicSharedMemorySize.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kQ = 64;         // steps per sub-chunk
constexpr int kMaxP = 64;      // head dim: 4 columns per thread
constexpr int kMaxN = 128;     // state dim: 8 columns per thread

constexpr size_t smem_floats(int P, int N) {
  // B and C rows padded by one float so column walks hit distinct banks
  return 2 * kQ * (N + 1)    // C_s, B_s
         + kQ * P            // x_s (decay-weighted before the update)
         + kQ * (kQ + 1)     // s_s: the masked, decayed C.B^T tile
         + P * (N + 1)       // st_s: the carried state
         + kQ;               // a_cum
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, float* __restrict__ state, int T,
                int H, int P, int N) {
  extern __shared__ float smem[];
  const int NS = N + 1, QS = kQ + 1;
  float* C_s = smem;                // [kQ][NS]
  float* B_s = C_s + kQ * NS;       // [kQ][NS]
  float* x_s = B_s + kQ * NS;       // [kQ][P]
  float* s_s = x_s + kQ * P;        // [kQ][QS]
  float* st_s = s_s + kQ * QS;      // [P][NS]
  float* ac_s = st_s + P * NS;      // [kQ]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid & 31;

  for (int i = tid; i < P * NS; i += kThreads) st_s[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kQ) {
    const int nq = min(kQ, T - t0);
    const long long row0 = (long long)b * T + t0;  // (b, t0) in (B, T)
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const bool ok = r < nq;
      C_s[r * NS + n] = ok ? Cm[(row0 + r) * N + n] : 0.f;
      B_s[r * NS + n] = ok ? Bm[(row0 + r) * N + n] : 0.f;
    }
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i % P;
      x_s[i] = r < nq ? x[((row0 + r) * H + h) * P + p] : 0.f;
    }
    if (tid < 32) {  // inclusive prefix sum of a: two steps per lane
      float s0 = lane < nq ? a[(row0 + lane) * H + h] : 0.f;
      float s1 = lane + 32 < nq ? a[(row0 + lane + 32) * H + h] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, s0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, s1, o);
        if (lane >= o) {
          s0 += u0;
          s1 += u1;
        }
      }
      ac_s[lane] = s0;
      ac_s[lane + 32] = s1 + __shfl_sync(0xffffffffu, s0, 31);
    }
    __syncthreads();

    // s[q][k] = k <= q ? exp(a_cum[q] - a_cum[k]) C[q].B[k] : 0, on a
    // 4 x 4 micro-tile: rows ty + 16i, columns tx + 16j
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = C_s[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = B_s[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = tx + 16 * j;
          s_s[q * QS + k] = k <= q ? expf(ac_s[q] - ac_s[k]) * s[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[q][p] = sum_k s[q][k] x[k][p] + exp(a_cum[q]) C[q].state[p]:
    // rows q = ty + 16i, columns p = tx + 16j
    {
      float acc[4][4], off[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = off[i][j] = 0.f;
      const int kmax = min(nq, ty + 16 * 3 + 1);  // s is 0 past the row
      for (int k = 0; k < kmax; ++k) {
        float sv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = s_s[(ty + 16 * i) * QS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          xv[j] = p < P ? x_s[k * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += sv[i] * xv[j];
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = C_s[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          sv[j] = p < P ? st_s[p * NS + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) off[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty + 16 * i;
        if (q >= nq) continue;
        const float dq = expf(ac_s[q]);
        float* yrow = y + ((row0 + q) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = acc[i][j] + dq * off[i][j];
        }
      }
    }
    __syncthreads();  // x_s and st_s are read; now they change

    const float a_last = ac_s[kQ - 1];  // pad steps add 0 to the sum
    for (int i = tid; i < kQ * P; i += kThreads)
      x_s[i] *= expf(a_last - ac_s[i / P]);
    __syncthreads();

    // state[p][n] = exp(a_last) state[p][n] + sum_k xw[k][p] B[k][n]:
    // rows p = ty + 16i, columns n = tx + 16j
    {
      float u[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) u[i][j] = 0.f;
      for (int k = 0; k < nq; ++k) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = ty + 16 * i;
          xv[i] = p < P ? x_s[k * P + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          bv[j] = n < N ? B_s[k * NS + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) u[i][j] += xv[i] * bv[j];
      }
      const float dl = expf(a_last);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n < N) st_s[p * NS + n] = st_s[p * NS + n] * dl + u[i][j];
        }
      }
    }
    __syncthreads();  // the next sub-chunk overwrites B_s, C_s, x_s
  }

  float* sb = state + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    sb[i] = st_s[(i / N) * NS + i % N];
}

}  // namespace

extern "C" {

// x, y (B, T, H, P); a (B, T, H); Bm, Cm (B, T, N); state (B, H, P, N); all
// f32 and contiguous. Returns 0, a CUDA error code from the attribute call
// or the launch, or -1 for an unsupported shape (P > 64, N > 128).
int ssd_scan_launch(const void* x, const void* a, const void* Bm,
                    const void* Cm, void* y, void* state, int B, int T, int H,
                    int P, int N, void* stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || N < 1 || P > kMaxP || N > kMaxN ||
      B > 65535)
    return -1;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxP, kMaxN) * sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const size_t smem = smem_floats(P, N) * sizeof(float);
  ssd_scan_kernel<<<dim3(H, B), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), static_cast<float*>(state), T, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int code) {
  return code < 0 ? "unsupported shape (head dim <= 64, state dim <= 128)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
