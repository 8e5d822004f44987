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
// Two bodies, one per dtype:
//
// * bf16 (the served path): both products on the tensor cores. Bound: at
//   the drain bucket (8 x 512) the bytes (q, k, v in, out back, 84 MB at
//   hd 128) take 25 us at 3.35 TB/s and the causal half of the products 17
//   us at 989 TFLOP/s, so the card is near its ridge and every product has
//   to run as `wgmma`: S = Q.K^T and O += P.V are warpgroup
//   `wgmma.mma_async` m64nNk16 (bf16 in, f32 accumulators), Q and P as A
//   fragments in registers, K and V as B operands read from shared memory
//   by descriptor. K is K-major (hd contiguous) as the model lays it out;
//   V is the same tile read MN-major (the descriptor's transpose bit), so
//   neither is transposed anywhere. GQA packing: a block serves one
//   (b, kv group, q tile) and its 64 rows hold the group's qpg heads x
//   64 / qpg positions (row r: position r / qpg, head r % qpg), so each
//   K/V tile is loaded once per group, not once per q head; at qpg 4 a
//   fleet prefill bucket of 16 fills the 64 rows exactly. K/V tiles move
//   by 16-byte `cp.async` into a ring of two stages and stay bf16 in
//   shared memory (32 KB a stage at hd 128 and 80, so three blocks share
//   an SM); the next tile is in flight while this one is multiplied.
//   What bounds it in practice is moving those tiles from L2: every q tile
//   of a group re-reads the group's K/V up to its diagonal, 302 MB at the
//   drain bucket. Tiles therefore sit in the 128-byte swizzled layout
//   (below), which lets a warp copy whole 128-byte lines with no bank
//   conflict (with 8-row core matrices and no swizzle each copy took a
//   64-byte piece of a line, and the loads set the kernel's time). P is
//   rounded to bf16 for P.V, as the einsum path does; max, sum and output
//   stay f32. Tiles above the diagonal are skipped; only tiles that cross
//   the diagonal or the ragged end of S are masked.
// * f32 (the parity gates: the f32 oracles of the serve paths): SIMT f32
//   FMA loops from shared memory (a 4 x 4 register micro-tile per thread
//   for Q.K^T, 4 x hd/16 for P.V), no TF32 anywhere. It is bound by the
//   67 TFLOP/s f32 rate and runs well below it; it exists for exactness,
//   not speed.
//
// A cache offset (chunked prefill). With `q_off` (B,) int32 given, q is
// one chunk of S queries and k / v are a layer of the serve pool with Sk
// >= S positions: query i of row b sits at position q_off[b] + i and, under
// `causal`, sees keys 0 .. q_off[b] + i -- the prefix that earlier chunks
// wrote and the chunk itself (the mask of the reference's
// `chunk_prefill_attention`, k_pos <= position). Key tiles past a block's
// last position are never loaded, so a chunk costs the filled prefix, not
// the allocated pool. With `kv_rows` (B,) int32 given, row b of q reads row
// kv_rows[b] of k / v, so a chunk of a few slots reads the fleet slab in
// place, with no gather. Without them (the single-shot prefill) q_off is 0,
// Sk = S and row b reads row b -- or, for full attention, Sk is any length:
// the S queries of a decoder's cross-attention over Sk encoder positions
// (every loop and mask here runs over Sk, not S).
//
// Layout: q (B, S, G, qpg, hd), k / v (B or more, Sk, G, hd), each by
// strides with a contiguous last dim -- the model's grouped layout, with no
// transpose. out (B, S, G, qpg, hd) contiguous. S is ragged: it need not be
// a multiple of the tile (serving buckets start at 4), and keys past Sk and
// queries past S are masked here -- padded rows are never stored -- instead
// of being asserted away. The bf16 body needs 16-byte aligned k / v rows and
// 4-byte aligned q rows (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ f32: SIMT

namespace simt {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile

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

// Grid: (ceil(S / 64) q tiles, Hq, B), heaviest causal q tiles first.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    const int* __restrict__ q_off,
                    const int* __restrict__ kv_rows, int S, int Sk, int G,
                    int qpg, int causal, long long q_sb,
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

  const int off = q_off != nullptr ? q_off[b] : 0;  // q_off + i: position
  const long long kr = kv_rows != nullptr ? kv_rows[b] : b;
  const float* qb = q + b * q_sb + g * q_sg + j * q_sj;
  const float* kb = k + kr * k_sb + g * k_sg;
  const float* vb = v + kr * v_sb + g * v_sg;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    q_s[r * kQS + d] = s < S ? qb[s * q_ss + d] : 0.f;
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

  const int k_end = causal ? min(Sk, off + q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with k_s / v_s / p_s
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int t = k0 + r;
      k_s[r * kQS + d] = t < Sk ? kb[t * k_ss + d] : 0.f;
      v_s[r * HD + d] = t < Sk ? vb[t * v_ss + d] : 0.f;
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
        const bool ok = t < Sk && (!causal || t <= off + q0 + r);
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
    const int n = min(kBK, Sk - k0);
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
    float* orow = out + (((long long)b * S + s) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < kDJ; ++c) orow[tx + 16 * c] = acc[a][c] * inv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* q_off, const int* kv_rows, int B, int S, int Sk, int G,
           int qpg, int causal, const long long* qs, const long long* ks,
           const long long* vs, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, G * qpg, B);
  flash_attention_f32<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), q_off, kv_rows,
      S, Sk, G, qpg, causal, qs[0], qs[1], qs[2], qs[3], ks[0], ks[1], ks[2],
      vs[0], vs[1], vs[2], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ----------------------------------------------- bf16: wgmma, GQA-packed

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kM = 64;         // packed (position, head) rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kStages = 2;     // K/V ring: tile it+1 loads while it is used
// tools/attention_breakdown.py builds the kernel with parts of its tile
// loop left out to see where the time goes: bit 1 drops the K/V loads
// past the first tile, bit 2 the products, bit 4 the softmax. 0, the
// default and the only value the port builds, is the whole kernel.
#ifndef FA_SKIP
#define FA_SKIP 0
#endif
// Shared-memory tile of kBK rows x HD in 128-byte swizzled atoms, the
// layout `wgmma` reads without bank conflicts: atom a holds columns
// 64a .. 64a+63 of every row, one 128-byte line a row, and the 16-byte
// chunk c of row t sits at chunk position c ^ (t % 8) of its line. A
// row's eight chunks so land in eight distinct bank groups, which lets a
// warp copy whole rows (coalesced) with conflict-free shared writes. Head
// dims that are not a multiple of 64 (32, 80) leave the tail of their
// last atom unused.
constexpr int kAtomElems = kBK * 64;         // one atom: kBK lines of 128 B
constexpr uint32_t kAtomBytes = kAtomElems * 2;
constexpr uint32_t kLinesBytes = 8 * 128;    // 8 rows: one swizzle period

template <int HD>
struct Atoms {  // 64-column atoms a row of HD columns takes
  static constexpr int n = (HD + 63) / 64;
};

template <int HD>
constexpr size_t smem_bytes() {   // + 1 KB to align the ring to 1024 B
  return size_t(kStages) * 2 * Atoms<HD>::n * kAtomBytes + 1024;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to the async proxy
// (wgmma reads its B operand through it)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading byte offset and stride byte offset, in 16-byte units.
// K-major (K): the stride offset is the 8-row period, 1024 B; the leading
// offset is unused. MN-major (V): the leading offset steps between atoms
// along N, the stride offset between 8-row periods along K.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) |
         (uint64_t(1) << 62);  // 128-byte swizzle
}

// 2^x by the special-function unit (MUFU.EX2), 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma m64nNk16, A (64 x 16 bf16) from registers, B by descriptor, f32
// accumulators d += A.B; TB = 1 reads B MN-major (transposed).
template <int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, %21;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, %37;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n80(float (&d)[40],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, 1, 1, 1, %45;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, %69;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB));
}


template <int N>
struct Mma;
template <>
struct Mma<32> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_n32<TB>(d, a, b);
  }
};
template <>
struct Mma<64> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_n64<TB>(d, a, b);
  }
};
template <>
struct Mma<80> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_n80<TB>(d, a, b);
  }
};
template <>
struct Mma<128> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_n128<TB>(d, a, b);
  }
};

// Rows t < kBK of K and V from key k0 on into one stage; rows past S (the
// key extent) are zero-filled (their scores are masked and 0 * 0 stays 0).
// Consecutive threads take consecutive chunks of a row, so a warp reads
// whole rows.
template <int HD>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs,
                                        const bf16* kb, const bf16* vb,
                                        long long k_ss, long long v_ss,
                                        int k0, int S, int tid) {
  constexpr int kC = HD / 8;
#pragma unroll
  for (int i = tid; i < kBK * kC; i += kThreads) {
    const int t = i / kC, c = i % kC;
    const bool ok = k0 + t < S;
    const long long row = ok ? k0 + t : 0;  // a valid address either way
    const int off = (c >> 3) * kAtomElems + t * 64 + ((c & 7) ^ (t & 7)) * 8;
    cp_async16(ks + off, kb + row * k_ss + c * 8, ok);
    cp_async16(vs + off, vb + row * v_ss + c * 8, ok);
  }
}

// Grid: (q tiles, G, B), heaviest causal tiles first. A q tile is
// ppt = 64 / qpg positions of all qpg heads of kv group g. Three blocks an
// SM (their 3 x 65 KB of shared memory fit): the bound holds the body to
// 168 registers a thread, which at 172 (the cache offset's two values
// more) fell to two blocks and lost 13% at the drain bucket.
template <int HD>
__global__ void __launch_bounds__(kThreads, 3)
flash_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     const int* __restrict__ q_off,
                     const int* __restrict__ kv_rows, int S, int Sk, int G,
                     int qpg, int causal, long long q_sb,
                     long long q_ss, long long q_sg, long long q_sj,
                     long long k_sb, long long k_ss, long long k_sg,
                     long long v_sb, long long v_ss, long long v_sg,
                     float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "unsupported head dim");
  constexpr int kKS = HD / 16;        // k-steps of Q.K^T
  constexpr int kO = HD / 2;          // output accumulators a thread

  constexpr int kTileAl = Atoms<HD>::n * kAtomElems;  // one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - static_cast<uint32_t>(
                               __cvta_generic_to_shared(smem_raw))) & 1023));

  const int ppt = kM / qpg;                   // positions a tile
  const int p0 = (gridDim.x - 1 - blockIdx.x) * ppt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // fragment row, column
  const int off = q_off != nullptr ? q_off[b] : 0;  // query i: off + i
  const long long kr = kv_rows != nullptr ? kv_rows[b] : b;

  // this thread's two packed rows, 16 warp + fr (+ 8): query index
  // (position off + pos), head, and whether the row is real (past S, or
  // past ppt * qpg when qpg does not divide 64, it is padding: loaded as
  // zeros and never stored)
  int pos[2], head[2];
  bool real[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + fr + 8 * i;
    head[i] = r % qpg;
    pos[i] = p0 + r / qpg;
    real[i] = r < ppt * qpg && pos[i] < S;
    if (!real[i]) pos[i] = min(pos[i], S - 1);  // any key 0 is visible
  }

  const bf16* kb = k + kr * k_sb + g * k_sg;
  const bf16* vb = v + kr * v_sb + g * v_sg;
  const int k_end = causal ? min(Sk, off + p0 + ppt) : Sk;
  const int n_kt = (k_end + kBK - 1) / kBK;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) {
      bf16* ks = smem + st * 2 * kTileAl;
      load_kv<HD>(ks, ks + kTileAl, kb, vb, k_ss, v_ss, st * kBK, Sk, tid);
    }
    cp_async_commit();
  }

  // Q as A fragments: k-step kk holds columns 16 kk + fc (+1) and (+8)
  uint32_t qf[kKS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bf16* qrow = q + b * q_sb + pos[i] * q_ss + g * q_sg +
                       head[i] * q_sj;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int col = 16 * kk + 8 * h8 + fc;
        qf[kk][2 * h8 + i] =
            real[i] ? *reinterpret_cast<const uint32_t*>(qrow + col) : 0u;
      }
    }
  }

  float o[kO];
#pragma unroll
  for (int e = 0; e < kO; ++e) o[e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    fence_async_shared();
    __syncthreads();  // everyone's copies of tile it landed, and tile
                      // it - 1's stage is free again
    {
      const int nt = it + kStages - 1;
      if (nt < n_kt && !(FA_SKIP & 1)) {
        bf16* ks = smem + (nt % kStages) * 2 * kTileAl;
        load_kv<HD>(ks, ks + kTileAl, kb, vb, k_ss, v_ss, nt * kBK, Sk,
                    tid);
      }
      cp_async_commit();
    }
    const bf16* ks = smem + (it % kStages) * 2 * kTileAl;
    const uint32_t k_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ks));
    const uint32_t v_addr = k_addr + kTileAl * sizeof(bf16);
    const int k0 = it * kBK;

    // S = Q.K^T: B is K (N = keys, K-major); k-step kk reads columns
    // 16 kk .. 16 kk + 15, 32 bytes into a line of atom kk / 4
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
      if (!(FA_SKIP & 2)) Mma<64>::run<0>(s, qf[kk],
                      desc(k_addr + (kk / 4) * kAtomBytes + (kk % 4) * 32,
                           16, kLinesBytes));
    wgmma_commit();
    wgmma_wait0();

    // accumulator e: row fr + 8 ((e >> 1) & 1), key k0 + 8 (e >> 2) + fc
    // + (e & 1). Mask only tiles that cross the diagonal or the key extent.
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > off + p0);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const int key = k0 + 8 * (e >> 2) + fc + (e & 1);
      const bool ok = !edge || (key < Sk && (!causal || key <= off + pos[i]));
      s[e] = ok ? s[e] * scale_log2 : -INFINITY;
    }
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2 && !(FA_SKIP & 4); ++i) {
      // row i's 16 values are s[4 n + 2 i + {0, 1}], n = 0 .. 7; max and
      // sum run as trees, not as 16-long chains
      float mx[8];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx[n] = fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]);
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int n = 0; n < w; ++n) mx[n] = fmaxf(mx[n], mx[n + w]);
      float m = mx[0];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(m_run[i], m);
      // key 0 is in tile 0 for every row, so m_new is finite from there
      // on; the guard keeps a NaN out all the same
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = ex2(m_run[i] - m_use);
      m_run[i] = m_new;
      float sum[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[4 * n + 2 * i] = ex2(s[4 * n + 2 * i] - m_use);
        s[4 * n + 2 * i + 1] = ex2(s[4 * n + 2 * i + 1] - m_use);
        sum[n] = s[4 * n + 2 * i] + s[4 * n + 2 * i + 1];
      }
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int n = 0; n < w; ++n) sum[n] += sum[n + w];
      l_run[i] = l_run[i] * alpha[i] + sum[0];  // this thread's keys only
    }
#pragma unroll
    for (int e = 0; e < kO; ++e) o[e] *= alpha[(e >> 1) & 1];

    // P as A fragments (bf16): k-step kk covers keys 16 kk .. 16 kk + 15
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pf[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }

    // O += P.V: B is V (K = keys, N = hd, MN-major); k-step kk reads
    // the lines of keys 16 kk .. 16 kk + 15
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      if (!(FA_SKIP & 2)) Mma<HD>::template run<1>(o, pf[kk],
                               desc(v_addr + kk * 16 * 128, kAtomBytes,
                                    kLinesBytes));
    wgmma_commit();
    wgmma_wait0();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[i] = 1.f / (l > 0.f ? l : 1.f);
  }
  const long long Hq = (long long)G * qpg;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!real[i]) continue;
    bf16* orow = out + (((long long)b * S + pos[i]) * Hq +
                        (long long)g * qpg + head[i]) * HD;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      const int e = 4 * n8 + 2 * i;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n8 + fc) =
          __floats2bfloat162_rn(o[e] * l_run[i], o[e + 1] * l_run[i]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* q_off, const int* kv_rows, int B, int S, int Sk, int G,
           int qpg, int causal, const long long* qs, const long long* ks,
           const long long* vs, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int ppt = kM / qpg;
  dim3 grid((S + ppt - 1) / ppt, G, B);
  flash_attention_bf16<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), q_off, kv_rows,
      S, Sk, G, qpg, causal, qs[0], qs[1], qs[2], qs[3], ks[0], ks[1], ks[2],
      vs[0], vs[1], vs[2], scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int dispatch(int dtype, int hd, const void* q, const void* k, const void* v,
             void* out, const int* q_off, const int* kv_rows, int B, int S,
             int Sk, int G, int qpg, int causal, const long long* qs,
             const long long* ks, const long long* vs, float scale,
             cudaStream_t st) {
#define FA_CASE(HD)                                                       \
  case HD:                                                                \
    return dtype == 0                                                     \
               ? simt::launch<HD>(q, k, v, out, q_off, kv_rows, B, S, Sk, \
                                  G, qpg, causal, qs, ks, vs, scale, st)  \
               : tc::launch<HD>(q, k, v, out, q_off, kv_rows, B, S, Sk,   \
                                G, qpg, causal, qs, ks, vs, scale, st);
  switch (hd) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(128)
    default: return -1;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT body), 1 = bfloat16 (tensor-core body); q, k,
// v and out share it. S queries a row, Sk keys. q_off (B,) int32: query i
// of row b at position q_off[b] + i, or null for 0 (then a causal call
// needs Sk = S; a full one takes any Sk: a cross-attention).
// kv_rows (B,) int32: the k / v row of each q row, or null for row b.
// q_strides (b, s, g, j), k_strides / v_strides (b, s, g), in elements.
// Returns 0, a CUDA error code from the attribute call or the launch, or
// -1 for an unsupported dtype / head dim / shape.
int flash_attention_launch(int dtype, int hd, const void* q, const void* k,
                           const void* v, void* out, const void* q_off,
                           const void* kv_rows, int B, int S, int Sk, int G,
                           int qpg, int causal, const long long* q_strides,
                           const long long* k_strides,
                           const long long* v_strides, float scale,
                           void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || G < 1 || qpg < 1 || qpg > tc::kM ||
      B > 65535 || G * qpg > 65535 || (dtype != 0 && dtype != 1) ||
      (q_off == nullptr && causal && Sk != S))
    return -1;
  return dispatch(dtype, hd, q, k, v, out, static_cast<const int*>(q_off),
                  static_cast<const int*>(kv_rows), B, S, Sk, G, qpg, causal,
                  q_strides, k_strides, v_strides, scale,
                  static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return code < 0 ? "unsupported dtype, head dim or shape"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
