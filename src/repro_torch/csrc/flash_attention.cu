// Flash attention for Hopper (sm_90a): causal or full GQA attention over a
// whole prompt -- the bucketed prefill of the serving engine.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. It computes the same function: q
// head h reads kv head h // qpg, an online softmax runs over K/V tiles with
// f32 running max, sum and output, and under `causal` the tiles above the
// diagonal are skipped. The TPU kernel's sequential kv grid axis becomes a
// loop inside one block; the blocks themselves run in no order.
//
// Bound: operations. A (64-query x 64-key) tile pair does 2 * 64 * 64 * hd
// multiply-adds for 2 * 64 * hd loaded K/V elements, so at the prompt
// lengths of a serving bucket the work, not the bytes, is the limit. This
// first version does that work with plain f32 FMA loops from shared memory
// (a 4 x 4 register micro-tile per thread for Q.K^T and a 4 x hd/16 one
// for P.V), so it runs far below the 989 TFLOP/s bf16 tensor-core peak the
// bound is stated against; moving both products onto `wgmma` is the
// planned next step for speed.
//
// Layout: q (B, S, G, qpg, hd), k / v (B, S, G, hd), each by strides with
// a contiguous last dim -- the model's grouped layout, with no transpose.
// out (B, S, G, qpg, hd) contiguous. S is ragged: it need not be a
// multiple of the tile (serving buckets start at 8), and keys and queries
// past S are masked here instead of being asserted away.
//
// Grid: (ceil(S / 64) q tiles, Hq, B), heaviest causal q tiles first.
// Head dims 32, 64, 80 (zamba2's shared block) and 128: any multiple of 16
// fits the 16 x 16 thread grid (hd / 16 output columns a thread).
// Shared memory: ~113 KB at hd 128, ~79 KB at hd 80, set through
// cudaFuncAttributeMaxDynamicSharedMemorySize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  // q and k rows padded by one float so column walks hit distinct banks
  return sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int G, int qpg, int causal, long long q_sb,
                       long long q_ss, long long q_sg, long long q_sj,
                       long long k_sb, long long k_ss, long long k_sg,
                       long long v_sb, long long v_ss, long long v_sg,
                       float scale) {
  static_assert(HD % 16 == 0, "unsupported head dim");
  constexpr int kQS = HD + 1;
  constexpr int kPS = kBK + 1;
  constexpr int kDJ = HD / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBQ][kQS]
  float* k_s = q_s + kBQ * kQS;      // [kBK][kQS]
  float* v_s = k_s + kBK * kQS;      // [kBK][HD]
  float* p_s = v_s + kBK * HD;       // [kBQ][kPS]
  float* m_s = p_s + kBQ * kPS;      // [kBQ]
  float* l_s = m_s + kBQ;            // [kBQ]
  float* a_s = l_s + kBQ;            // [kBQ]

  const int qt = gridDim.x - 1 - blockIdx.x;  // long causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / qpg, j = h % qpg;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid & 31, warp = tid >> 5;

  const T* qb = q + b * q_sb + g * q_sg + j * q_sj;
  const T* kb = k + b * k_sb + g * k_sg;
  const T* vb = v + b * v_sb + g * v_sg;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    q_s[r * kQS + d] = s < S ? to_f32(qb[s * q_ss + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[4][kDJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDJ; ++c) acc[a][c] = 0.f;

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with k_s / v_s / p_s
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int t = k0 + r;
      k_s[r * kQS + d] = t < S ? to_f32(kb[t * k_ss + d]) : 0.f;
      v_s[r * HD + d] = t < S ? to_f32(vb[t * v_ss + d]) : 0.f;
    }
    __syncthreads();

    // S = Q.K^T on a 4 x 4 micro-tile: rows ty + 16a, keys tx + 16c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(ty + 16 * a) * kQS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = k_s[(tx + 16 * c) * kQS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += qa[a] * kc[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const int t = k0 + col;
        const bool ok = t < S && (!causal || t <= q0 + r);
        p_s[r * kPS + col] = ok ? s[a][c] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, two keys per lane
    for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
      const float s0 = p_s[r * kPS + lane], s1 = p_s[r * kPS + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      // a row with every key masked so far keeps a zero output
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float e0 = expf(s0 - m_use), e1 = expf(s1 - m_use);
      const float sum = warp_sum(e0 + e1);
      p_s[r * kPS + lane] = e0;
      p_s[r * kPS + lane + 32] = e1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_use);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P.V on rows ty + 16a, columns tx + 16c
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = a_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < kDJ; ++c) acc[a][c] *= alpha;
    }
    const int n = min(kBK, S - k0);
    for (int t = 0; t < n; ++t) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_s[(ty + 16 * a) * kPS + t];
#pragma unroll
      for (int c = 0; c < kDJ; ++c) {
        const float vv = v_s[t * HD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] += pa[a] * vv;
      }
    }
  }

  const int Hq = G * qpg;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int s = q0 + r;
    if (s >= S) continue;
    const float l = l_s[r];
    const float inv = 1.f / (l > 0.f ? l : 1.f);
    T* orow = out + (((long long)b * S + s) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < kDJ; ++c) store(orow + tx + 16 * c, acc[a][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int G, int qpg, int causal, const long long* qs,
           const long long* ks, const long long* vs, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, G * qpg, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, G, qpg, causal,
      qs[0], qs[1], qs[2], qs[3], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int S, int G, int qpg, int causal,
                const long long* qs, const long long* ks, const long long* vs,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, G, qpg, causal, qs, ks, vs, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, G, qpg, causal, qs, ks, vs, scale, stream);
    case 80: return launch<T, 80>(q, k, v, out, B, S, G, qpg, causal, qs, ks, vs, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, G, qpg, causal, qs, ks, vs, scale, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q_strides (b, s, g, j), k_strides / v_strides (b, s, g), in elements.
// Returns 0, a CUDA error code from the attribute call or the launch, or
// -1 for an unsupported dtype / head dim / shape.
int flash_attention_launch(int dtype, int hd, const void* q, const void* k,
                           const void* v, void* out, int B, int S, int G,
                           int qpg, int causal, const long long* q_strides,
                           const long long* k_strides,
                           const long long* v_strides, float scale,
                           void* stream) {
  if (B < 1 || S < 1 || G < 1 || qpg < 1 || B > 65535 || G * qpg > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, S, G, qpg, causal,
                              q_strides, k_strides, v_strides, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, G, qpg, causal,
                                      q_strides, k_strides, v_strides, scale,
                                      st);
  return -1;
}

const char* flash_attention_error_string(int code) {
  return code < 0 ? "unsupported dtype, head dim or shape"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
