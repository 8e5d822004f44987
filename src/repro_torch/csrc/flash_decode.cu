// Flash-decode for Hopper (sm_90a): single-token GQA attention of one new
// query per row over that row's filled KV cache, split along the cache.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `flash_decode` in
// src/repro/kernels/decode_attention.py. Row b attends cache positions
// 0..pos[b] inclusive with an online softmax over KV tiles; tiles past
// pos[b] are never read, so a step costs the *filled* cache, not the
// allocated one.
//
// Bound: bytes. Each KV element is read once and used for qpg (4 at
// granite-3-8b) multiply-adds, far below the ~295 operations per byte the
// card needs before compute is the limit. The design therefore reads the
// cache exactly once, in its own dtype and in the serve layout
// (B, S, G, hd) by strides -- no transpose and no cast copy of the cache
// (the JAX reference transposes and casts it on every call) -- and serves
// all qpg q heads of a kv group from one block so the group's K/V stream
// is shared. A 64-position K/V tile moves into shared memory with
// 16-byte `cp.async` copies, double-buffered so the next tile is in flight
// while this one is used; each thread then dots its own position against
// its q heads from shared memory, so no score waits on a chain of warp
// shuffles. The q heads a block serves are a compile-time bound (1, 4 or
// 16 by the group size), so no thread carries accumulators for heads the
// model does not have.
//
// Split-KV: the time of one block walking a long row in series, not the
// bytes, limited the step (a pool of 8 rows x 8 groups is 64 blocks on 132
// SMs). So each row's filled positions are cut into chunks of a FIXED
// length, kChunk = 128 (two tiles), and each chunk is one block: the grid
// is B * G * ceil(S / kChunk), S the allocated cache length, which the host
// knows; the host never reads pos. A block whose chunk starts past pos[b]
// exits at once. The length does not follow the batch, so a row's result
// is the same alone or in any batch (the serving checks rely on it). A row
// with one chunk (pos[b] < 128) writes its output directly as acc / l. A
// row with more leaves per chunk a partial (running max m, sum l and the
// unnormalised output acc, f32) in the scratch the wrapper allocates, and
// the last of its blocks to finish -- found by a per-(b, g) ticket counter
// -- merges them by their log-sum-exp, in chunk order, so the result does
// not depend on which block came last. The merge runs in the same launch,
// not in a second kernel: a decode step is host-bound and latency-bound,
// and a second launch would add its own latency to every attention layer
// of every step, also where no row has a second chunk (the control loop's
// slab). The ticket counters live in a buffer the wrapper keeps per
// device, zeroed once; the merging block resets its counter to 0, so every
// launch finds them zero.
//
// The int8 cache (the reference's `repro.serving.kv_quant` codec: int8
// K / V, one f32 absmax scale a (position, kv head)). The reference
// dequantizes a layer's whole pool and then attends; here the dequant
// happens in the loads: the tile moves into shared memory as int8, its 64
// scales a stage beside it (4-byte `cp.async`), and each value is
// q * scale, rounded to the query's dtype as the reference's `astype`
// rounds it, where it is used. The HBM stream is the int8 bytes plus the
// scales -- a quarter of an f32 pool's bytes and 0.52 of a bf16 pool's at
// hd 128, which is what the codec is for. The split-KV design and the
// merge are the same as for a float cache.
//
// Layout: q (B, G, qpg, hd) by strides, caches (B, S, G, hd) by strides
// with 16-byte aligned rows, scales (B, S, G) f32 by strides (int8 only),
// pos (B,) int32 on the device (read by the block itself: no host sync),
// out (B, G, qpg, hd) contiguous, partials f32 [B * G * n_chunks][qpg *
// hd] then [B * G * n_chunks][qpg][m, l], tickets int32 [B * G].
// Accumulation (max, sum, output) is f32 whatever the input dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;    // KV positions per tile (2 per lane in softmax)
constexpr int kChunk = 128;  // KV positions per block: fixed, see above
constexpr int kMaxQpg = 16;  // q heads per kv group served by one block
constexpr int kHGroups = kThreads / kTile;  // threads sharing one position

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
// a dequantized value rounded to the query's dtype T
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of shared memory as f32 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}

// 16-byte global -> shared copy; with `ok` false it writes zeros instead
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// A stage holds the K and V tiles in the cache's type TC and, for int8,
// their 2 x kTile scales after them (f32).
template <typename TC, int HD, int QMAX>
struct Layout {
  static constexpr bool kQuant = sizeof(TC) == 1;
  static constexpr int kVec = 16 / sizeof(TC);     // elements per 16 B
  static constexpr int kKRow = HD + kVec;          // padded K row
  static constexpr int kKV = kTile * kKRow + kTile * HD;  // K + V, in TC
  static constexpr int kScaleBytes = kQuant ? 2 * kTile * 4 : 0;
  static constexpr int kStageBytes = kKV * sizeof(TC) + kScaleBytes;
  static constexpr size_t bytes =
      2 * kStageBytes + sizeof(float) * (QMAX * HD + QMAX * kTile + 3 * QMAX);
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
};

// Scales of an int8 cache: (B, S, G) f32 by strides, K's and V's alike
struct Scales {
  const float* k;
  const float* v;
  long long sb, ss, sg;
};

// rows t0 .. t0+kTile-1 of K and V (and their scales) into one stage; rows
// past `last` are zero-filled (their p is 0, and 0 * 0 stays 0)
template <typename TC, int HD>
__device__ __forceinline__ void load_tile(TC* ks, TC* vs, float* sc,
                                          const TC* kb, const TC* vb,
                                          const float* kscb,
                                          const float* vscb, long long k_ss,
                                          long long v_ss, long long s_ss,
                                          int t0, int last, int tid) {
  constexpr int kVec = 16 / sizeof(TC);
  constexpr int kKRow = HD + kVec;
  constexpr int kPerRow = HD / kVec;
  for (int i = tid; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool ok = t0 + r <= last;
    const long long t = ok ? t0 + r : 0;  // a valid address either way
    cp_async16(ks + r * kKRow + c, kb + t * k_ss + c, ok);
    cp_async16(vs + r * HD + c, vb + t * v_ss + c, ok);
  }
  if constexpr (sizeof(TC) == 1) {  // K's scales, then V's
    static_assert(kThreads == 2 * kTile, "one scale a thread");
    const int r = tid % kTile;
    const bool ok = t0 + r <= last;
    const long long t = ok ? t0 + r : 0;
    cp_async4(sc + tid, (tid < kTile ? kscb : vscb) + t * s_ss, ok);
  }
}

// Grid: B * G * n_chunks blocks, chunk index fastest. T is the type of q
// and out, TC the cache's (T, or int8_t with `sc` its scales).
template <typename T, typename TC, int HD, int QMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const TC* __restrict__ k,
                    const TC* __restrict__ v, Scales kvs,
                    const int* __restrict__ pos, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int G, int qpg, int S, int n_chunks, long long q_sb,
                    long long q_sg, long long q_sj, long long k_sb,
                    long long k_ss, long long k_sg, long long v_sb,
                    long long v_ss, long long v_sg, float scale) {
  using L = Layout<TC, HD, QMAX>;
  static_assert(HD % 16 == 0, "unsupported head dim");
  // output element a of a thread is o = tid + a * kThreads: q head o / HD,
  // column o % HD. When HD divides kThreads (32, 64, 128) all of a
  // thread's elements share one column, so one V value serves them all;
  // otherwise (80, zamba2's shared block) each element reads its own.
  constexpr bool kOneCol = kThreads % HD == 0;
  constexpr int kHStep = kThreads / HD;  // (kOneCol) heads a column step
  constexpr int kAcc = (QMAX * HD + kThreads - 1) / kThreads;
  constexpr int kOwn = (QMAX + kHGroups - 1) / kHGroups;  // scored heads

  extern __shared__ __align__(16) unsigned char smem[];
  // stage i: K tile, V tile, scales, at smem + i * kStageBytes
  const auto k_tile = [&](int i) {
    return reinterpret_cast<TC*>(smem + i * L::kStageBytes);
  };
  const auto scales = [&](int i) {
    return reinterpret_cast<float*>(smem + i * L::kStageBytes +
                                    L::kKV * sizeof(TC));
  };
  float* q_s = reinterpret_cast<float*>(smem + 2 * L::kStageBytes);  // [qpg][HD]
  float* p_s = q_s + QMAX * HD;                              // [qpg][kTile]
  float* m_s = p_s + QMAX * kTile;
  float* l_s = m_s + QMAX;
  float* a_s = l_s + QMAX;
  __shared__ int merge_s;

  const int bg = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x % n_chunks;
  const int b = bg / G, g = bg % G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_last = min(pos[b], S - 1);
  const int n_live = row_last < 0 ? 1 : row_last / kChunk + 1;
  if (chunk >= n_live) return;  // nothing of this row's cache is here
  const int t_begin = chunk * kChunk;
  const int last = min(row_last, t_begin + kChunk - 1);
  const TC* kb = k + b * k_sb + g * k_sg;
  const TC* vb = v + b * v_sb + g * v_sg;
  const float* kscb = L::kQuant ? kvs.k + b * kvs.sb + g * kvs.sg : nullptr;
  const float* vscb = L::kQuant ? kvs.v + b * kvs.sb + g * kvs.sg : nullptr;

  load_tile<TC, HD>(k_tile(0), k_tile(0) + kTile * L::kKRow, scales(0), kb,
                    vb, kscb, vscb, k_ss, v_ss, kvs.ss, t_begin, last, tid);
  cp_async_commit();
  for (int i = tid; i < qpg * HD; i += kThreads) {
    const int j = i / HD, d = i % HD;
    q_s[j * HD + d] = to_f32(q[b * q_sb + g * q_sg + j * q_sj + d]);
  }
  if (tid < qpg) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int d_own = tid % HD;      // (kOneCol) output column of this thread
  const int h_own = tid / HD;      // (kOneCol) first of its output heads
  const int jj = tid % kTile;      // score position of this thread
  const int hg = tid / kTile;      // first of its score heads
  const auto head_of = [&](int a) {  // q head of output element a
    return kOneCol ? h_own + a * kHStep : (tid + a * kThreads) / HD;
  };
  const auto col_of = [&](int a) {   // column of output element a
    return kOneCol ? d_own : (tid + a * kThreads) % HD;
  };
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  for (int t0 = t_begin, it = 0; t0 <= last; t0 += kTile, ++it) {
    const TC* ks = k_tile(it & 1);
    const TC* vs = ks + kTile * L::kKRow;
    const float* ksc = scales(it & 1);      // (int8) K's scales, V's after
    const float* vsc = ksc + kTile;
    if (t0 + kTile <= last) {  // next tile into the other stage
      const int nx = (it + 1) & 1;
      load_tile<TC, HD>(k_tile(nx), k_tile(nx) + kTile * L::kKRow,
                        scales(nx), kb, vb, kscb, vscb, k_ss, v_ss, kvs.ss,
                        t0 + kTile, last, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: thread (jj, hg) dots position t0+jj with q heads hg, hg+2, ..
    float sc[kOwn];
#pragma unroll
    for (int a = 0; a < kOwn; ++a) sc[a] = 0.f;
    const TC* krow = ks + jj * L::kKRow;
    const float kscale = L::kQuant ? ksc[jj] : 1.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += L::kVec) {
      float kf[L::kVec];
      load16(krow + d, kf);
      if constexpr (L::kQuant) {
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) kf[e] = round_to<T>(kf[e] * kscale);
      }
#pragma unroll
      for (int a = 0; a < kOwn; ++a) {
        const int j = hg + a * kHGroups;
        if (j < qpg) {
#pragma unroll
          for (int e = 0; e < L::kVec; ++e)
            sc[a] += q_s[j * HD + d + e] * kf[e];
        }
      }
    }
    const bool live = t0 + jj <= last;
#pragma unroll
    for (int a = 0; a < kOwn; ++a) {
      const int j = hg + a * kHGroups;
      if (j < qpg) p_s[j * kTile + jj] = live ? sc[a] * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax: warp w takes q heads w, w+kWarps, ...
    for (int j = warp; j < qpg; j += kWarps) {
      float* pr = p_s + j * kTile;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_prev = m_s[j];
      // position t0 <= last is in every tile, so m_new is finite
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float sum = warp_sum(e0 + e1);
      pr[lane] = e0;
      pr[lane + 32] = e1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[j] = alpha;
        l_s[j] = l_s[j] * alpha + sum;
        m_s[j] = m_new;
      }
    }
    __syncthreads();

    // acc[h] = acc[h] * alpha[h] + sum_t p[h][t] * v[t][d]
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int j = head_of(a);
      if (j < qpg) acc[a] *= a_s[j];
    }
    const int n = min(kTile, last - t0 + 1);
    // a V value: the float cache's own, or int8 * scale in T
    const auto v_at = [&](int t, int col) {
      const float x = to_f32(vs[t * HD + col]);
      return L::kQuant ? round_to<T>(x * vsc[t]) : x;
    };
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      if constexpr (kOneCol) {
        const float vv = v_at(t, d_own);
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const int j = head_of(a);
          if (j < qpg) acc[a] += p_s[j * kTile + t] * vv;
        }
      } else {
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const int j = head_of(a);
          if (j < qpg) acc[a] += p_s[j * kTile + t] * v_at(t, col_of(a));
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  T* ob = out + ((long long)b * G + g) * qpg * HD;
  if (n_live == 1) {  // the whole row was this block's: acc / l
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int j = head_of(a);
      if (j < qpg) {
        const float l = l_s[j];
        store(ob + j * HD + col_of(a), acc[a] / (l > 0.f ? l : 1.f));
      }
    }
    return;
  }

  // leave this chunk's partial; the last block of the row merges
  const int n_parts = gridDim.x;
  float* p_acc = part + (long long)blockIdx.x * qpg * HD;
  float* p_ml = part + (long long)n_parts * qpg * HD;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int j = head_of(a);
    if (j < qpg) p_acc[j * HD + col_of(a)] = acc[a];
  }
  if (tid < qpg) {
    p_ml[((long long)blockIdx.x * qpg + tid) * 2] = m_s[tid];
    p_ml[((long long)blockIdx.x * qpg + tid) * 2 + 1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(tickets + bg, 1);
    merge_s = done == n_live - 1;
    if (merge_s) tickets[bg] = 0;  // every block of the row has arrived
  }
  __syncthreads();
  if (!merge_s) return;
  __threadfence();

  const long long first = (long long)bg * n_chunks;  // partial of chunk 0
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int j = head_of(a);
    if (j >= qpg) continue;
    const int col = col_of(a);
    float m_max = -INFINITY;
    for (int cc = 0; cc < n_live; ++cc)
      m_max = fmaxf(m_max, __ldcg(p_ml + ((first + cc) * qpg + j) * 2));
    float num = 0.f, den = 0.f;
    for (int cc = 0; cc < n_live; ++cc) {
      const long long ml = ((first + cc) * qpg + j) * 2;
      const float w = expf(__ldcg(p_ml + ml) - m_max);
      den += w * __ldcg(p_ml + ml + 1);
      num += w * __ldcg(part + (first + cc) * qpg * HD + j * HD + col);
    }
    store(ob + j * HD + col, num / den);
  }
}

template <typename T, typename TC, int HD, int QMAX>
int launch(const void* q, const void* k, const void* v, const Scales& sc,
           const void* pos, void* out, void* part, void* tickets, int B,
           int G, int qpg, int S, const long long* qs, const long long* ks,
           const long long* vs, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<TC, HD, QMAX>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T, TC, HD, QMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int n_chunks = (S + kChunk - 1) / kChunk;
  flash_decode_kernel<T, TC, HD, QMAX>
      <<<B * G * n_chunks, kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const TC*>(k),
          static_cast<const TC*>(v), sc, static_cast<const int*>(pos),
          static_cast<T*>(out), static_cast<float*>(part),
          static_cast<int*>(tickets), G, qpg, S, n_chunks, qs[0], qs[1],
          qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TC, int HD>
int dispatch_qpg(const void* q, const void* k, const void* v,
                 const Scales& sc, const void* pos, void* out, void* part,
                 void* tickets, int B, int G, int qpg, int S,
                 const long long* qs, const long long* ks,
                 const long long* vs, float scale, cudaStream_t st) {
  if (qpg == 1)
    return launch<T, TC, HD, 1>(q, k, v, sc, pos, out, part, tickets, B, G,
                                qpg, S, qs, ks, vs, scale, st);
  if (qpg <= 4)
    return launch<T, TC, HD, 4>(q, k, v, sc, pos, out, part, tickets, B, G,
                                qpg, S, qs, ks, vs, scale, st);
  return launch<T, TC, HD, kMaxQpg>(q, k, v, sc, pos, out, part, tickets, B,
                                    G, qpg, S, qs, ks, vs, scale, st);
}

template <typename T, typename TC>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const Scales& sc, const void* pos, void* out, void* part,
                void* tickets, int B, int G, int qpg, int S,
                const long long* qs, const long long* ks,
                const long long* vs, float scale, cudaStream_t st) {
#define FD_CASE(HD)                                                         \
  case HD:                                                                  \
    return dispatch_qpg<T, TC, HD>(q, k, v, sc, pos, out, part, tickets, B, \
                                   G, qpg, S, qs, ks, vs, scale, st);
  switch (hd) {
    FD_CASE(32)
    FD_CASE(64)
    FD_CASE(80)
    FD_CASE(128)
    default: return -1;
  }
#undef FD_CASE
}

}  // namespace

extern "C" {

// The fixed chunk length; the wrapper sizes the partials by it.
int flash_decode_chunk(void) { return kChunk; }

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
// q_strides (b, g, j), k_strides / v_strides (b, s, g), in elements.
// Cache rows must be 16-byte aligned (base and strides). `part` holds
// B * G * ceil(S / 128) * qpg * (hd + 2) floats; `tickets` B * G int32
// zeros, and is left zero. Returns 0, a CUDA error code from the
// attribute call or the launch, or -1 for an unsupported dtype / head dim
// / group size.
int flash_decode_launch(int dtype, int hd, const void* q, const void* k,
                        const void* v, const void* pos, void* out,
                        void* part, void* tickets, int B, int G, int qpg,
                        int S, const long long* q_strides,
                        const long long* k_strides,
                        const long long* v_strides, float scale,
                        void* stream) {
  if (qpg < 1 || qpg > kMaxQpg || B < 1 || G < 1 || S < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scales none{nullptr, nullptr, 0, 0, 0};
  if (dtype == 0)
    return dispatch_hd<float, float>(hd, q, k, v, none, pos, out, part,
                                     tickets, B, G, qpg, S, q_strides,
                                     k_strides, v_strides, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, q, k, v, none, pos, out, part, tickets, B, G, qpg, S, q_strides,
        k_strides, v_strides, scale, st);
  return -1;
}

// The int8 cache: k / v int8 (B, S, G, hd) with 16-byte aligned rows, their
// scales k_scale / v_scale f32 (B, S, G) sharing s_strides (b, s, g); q and
// out in `dtype` (0 float32, 1 bfloat16), the dequantized values rounded
// to it. Otherwise as flash_decode_launch.
int flash_decode_int8_launch(int dtype, int hd, const void* q, const void* k,
                             const void* v, const void* k_scale,
                             const void* v_scale, const void* pos, void* out,
                             void* part, void* tickets, int B, int G,
                             int qpg, int S, const long long* q_strides,
                             const long long* k_strides,
                             const long long* v_strides,
                             const long long* s_strides, float scale,
                             void* stream) {
  if (qpg < 1 || qpg > kMaxQpg || B < 1 || G < 1 || S < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scales sc{static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale), s_strides[0],
                  s_strides[1], s_strides[2]};
  if (dtype == 0)
    return dispatch_hd<float, int8_t>(hd, q, k, v, sc, pos, out, part,
                                      tickets, B, G, qpg, S, q_strides,
                                      k_strides, v_strides, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16, int8_t>(
        hd, q, k, v, sc, pos, out, part, tickets, B, G, qpg, S, q_strides,
        k_strides, v_strides, scale, st);
  return -1;
}

const char* flash_decode_error_string(int code) {
  return code < 0 ? "unsupported dtype, head dim or group size"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
