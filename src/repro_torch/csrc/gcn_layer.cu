// The GCN of the paper's Eq. 6 for Hopper (sm_90a), f32: one layer
// relu?(A_hat . X . W + b), or the balancer's whole greedy action -- L GCN
// layers, the actor's per-node head and the masked softmax over the nodes
// -- in one launch.
//
// Replaces the Pallas TPU kernel `_gcn_kernel` / `gcn_layer` in
// src/repro/kernels/gcn_fused.py (one layer, A_hat . X kept in VMEM). The
// balancer runs two layers and a head on every control tick
// (repro.core.ddpg.actor_action).
//
// Shapes: A_hat (N, N), X (Bt, N, F), W_l (d_l, d_{l+1}) with d_0 = F,
// b_l (d_{l+1},), all contiguous f32. The head: W1 (d_L + F, hidden), b1
// (hidden,), W2 (hidden, 1), b2 (1,), and optional noise and up-mask rows
// of N (one for every batch element, or one for all). One layer writes
// (Bt, N, d_1); the action writes the fractions (Bt, N).
//
// Bound: neither bytes nor operations. The control plane's graphs are tiny
// (N = 2 at the serve defaults, 16 in the paper's cluster): the inputs and
// weights are ~60 KB and the action ~60 KFLOP at the serve defaults (~0.7
// MFLOP at N 16), nanoseconds at 3.35 TB/s or 67 TFLOP/s f32. What bounds a
// call is its launch (a few microseconds) and, inside it, chains of
// dependent loads and barriers. The balancer's action used to be ~10
// launches (two layers, concat, the head's matmuls, bias adds and relu,
// mask, softmax). So the design is one launch and one block per
// observation, with every intermediate in shared memory:
//
//   * one layer (gcn_layer_launch): one block per (tile of kTM output
//     rows, batch element). The block computes its kTM x F rows of
//     A_hat . X into shared memory, streaming X through shared memory kKM
//     rows at a time with the matching kTM x kKM tile of A_hat, then
//     multiplies them by W (read through the read-only cache), adds b,
//     applies the relu and writes out. A_hat . X never reaches HBM;
//   * the action (gcn_actor_launch): one block of 256 threads per
//     observation (grid (Bt,)). It first puts everything it reads in
//     flight to shared memory, in one group a layer: X, A_hat, the mask
//     and noise rows with layer 0's weights, then each layer's weights,
//     then the head's. Thread 0 sends each buffer's whole 16 bytes as one
//     bulk copy of the tensor memory accelerator, completing on the
//     group's mbarrier; the block sends the rest (an unaligned source, a
//     ragged end) by 4-byte cp.async. Each layer waits only for its own
//     group, and no thread walks a chain of loads from L2. A layer runs
//     over row tiles of the whole graph: the tile's rows of A_hat . h,
//     then . W + b, from and to shared memory; two output buffers
//     ping-pong, so layer l + 1 never overwrites what layer l still reads.
//     Layers relu all but the last. The head reads [h_L, X] (the concat is
//     implicit): each (node, hidden unit) belongs to one thread, 32
//     consecutive units to one warp, which folds relu(.W1 + b1) . W2 into a
//     warp sum; the node's logit sums its warps' partials in order, adds
//     b2, the noise, and takes -1e9 where the node is down. A block
//     reduction (max, then the sum of exp) gives the softmax; with every
//     node down it is the uniform split, as in the plain version.
//
// Each product gives a thread up to kRows output rows of one column, so
// each weight it reads serves them all. Plain f32 FMA throughout: TF32
// would not move a launch-bound time and would risk the f32 gate. Ragged
// row tiles and X chunks are masked; the hidden width is padded to a warp.
// Shared memory is Layout::total floats (mirrored by kernels/gcn_fused.py
// smem_bytes): above 48 KB it is requested through the
// max-dynamic-shared-memory function attribute, up to the card's 227 KB.
// One layer takes F up to ~1,800 at any N; the action at the paper's widths
// takes N up to 144 nodes (F 12) or 126 (F 36), A_hat being N x N.
//
// The backward of one layer (gcn_layer_bwd_launch), for the DDPG update's
// gradients. The reference's Pallas kernel has no VJP: it trains through
// its plain XLA GCN. With H = act(A_hat . X . W + b) and G = dH where the
// layer's relu passed (H > 0; everywhere without the relu), one launch
// computes dW = sum_b (A_hat . X_b)^T . G_b, db = sum_{b, nodes} G and,
// when asked, dX_b = A_hat^T . (G_b . W^T). It recomputes A_hat . X (a
// tile of N x 4, cheap) instead of having the forward save it, so the
// forward kernel is unchanged. At the update's shapes (Bt 128 graphs of N 8
// or 16, F 36 or 64 into H 64) a launch moves 0.7-1.6 MB and does 5-42
// MFLOP: under 0.7 us at 3.35 TB/s or at 67 TFLOP/s f32; like the forward,
// it is bound by its launch and its chains of loads and barriers.
// So the work spreads over the card: dW is cut into tiles of 4 input
// features and the batch into chunks of up to 128 nodes (8 graphs of 16),
// one block each (144 blocks at N 16, F 36), and each block leaves its
// tile's partial sum over its chunk. The sums over the batch are
// deterministic -- no float atomics, no order that depends on scheduling:
// every partial entry is one thread's sum in row order, and the last block
// of a tile to finish (an integer ticket counter a tile, which the wrapper
// keeps zeroed per device and the launch leaves zero) adds the tile's
// partials in chunk order. Block 0's tile also sums db. dX takes one block
// a graph, with W staged in shared memory (coalesced loads, rows padded
// against bank conflicts). Two runs of the same training give the same
// weights.
//
// For tools/gcn_breakdown.py, -DGCN_SKIP=bits leaves parts of the action
// out (1 the head's products, 2 the products by W, 4 the products
// A_hat . h, 8 the copies of A_hat and the weights, 16 the softmax), so
// that it computes garbage: only its time means anything.
#include <cstdint>

#include <cuda_runtime.h>

#ifndef GCN_SKIP
#define GCN_SKIP 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 16;    // output rows a tile
constexpr int kKM = 16;    // input rows (columns of A_hat) a step
constexpr int kRows = 4;   // output rows a thread carries, a product
constexpr int kMaxLayers = 4;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit

struct Layers {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dim[kMaxLayers + 1];  // dim[0] = F, dim[l + 1] = layer l's width
  int n_layers;
  int relu_last;            // one layer alone: relu after it
};

struct Head {               // the actor's head; w1 == nullptr: one layer
  const float* w1;          // (dim[L] + F, hidden)
  const float* b1;          // (hidden,)
  const float* w2;          // (hidden, 1)
  const float* b2;          // (1,)
  const float* noise;       // nullptr, or rows of n, noise_bs apart
  const float* mask;        // nullptr, or rows of n, mask_bs apart
  int hidden;
  int noise_bs, mask_bs;    // n (a row per batch element) or 0 (one row)
};

// Offsets (in floats, each a multiple of 4) of the shared-memory buffers;
// -1: unused. Computed on the host and passed to the kernel.
struct Layout {
  int ax, as, xs, hx, h0, h1, part, logit, red, mask, noise, bar;
  int w[kMaxLayers], b[kMaxLayers], w1, b1, w2, b2;
  int total;
};

// One layer alone (hidden 0): a tile of A_hat . X and the staging of X and
// A_hat in tiles. The action: everything it reads and makes, whole.
Layout make_layout(int n, const Layers& ly, int hidden) {
  Layout s;
  s.ax = s.as = s.xs = s.hx = s.h0 = s.h1 = s.part = s.logit = s.red = -1;
  s.mask = s.noise = s.bar = s.w1 = s.b1 = s.w2 = s.b2 = -1;
  int fin = 0, fout = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    s.w[l] = s.b[l] = -1;
    if (l < ly.n_layers) {
      fin = fin > ly.dim[l] ? fin : ly.dim[l];
      fout = fout > ly.dim[l + 1] ? fout : ly.dim[l + 1];
    }
  }
  int o = 0;
  auto take = [&o](int floats) {
    const int at = o;
    o += (floats + 3) & ~3;  // 16-byte aligned buffers, for the copies
    return at;
  };
  s.ax = take(kTM * fin);      // a tile's rows of A_hat . h
  if (hidden == 0) {
    s.as = take(kTM * kKM);    // a tile of A_hat
    s.xs = take(kKM * fin);    // the staged rows of X
  } else {
    s.bar = take(2 * (kMaxLayers + 1));  // a copy barrier a group
    s.as = take(n * n);                  // A_hat
    s.hx = take(n * ly.dim[0]);          // X
    s.h0 = take(n * fout);               // the layers' outputs, ping-pong
    if (ly.n_layers > 1) s.h1 = take(n * fout);
    for (int l = 0; l < ly.n_layers; ++l) {
      s.w[l] = take(ly.dim[l] * ly.dim[l + 1]);
      s.b[l] = take(ly.dim[l + 1]);
    }
    s.w1 = take((ly.dim[ly.n_layers] + ly.dim[0]) * hidden);
    s.b1 = take(hidden);
    s.w2 = take(hidden);
    s.b2 = take(1);
    s.mask = take(n);                         // the up-mask row
    s.noise = take(n);                        // the noise row
    s.part = take(n * ((hidden + 31) / 32));  // the head's warp partials
    s.logit = take(n);                        // logits, then exp
    s.red = take(kWarps);                     // block reductions
  }
  s.total = o;
  return s;
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's cp.async groups are in
// flight (the count must be an immediate, hence the switch).
__device__ inline void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

__device__ inline void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Makes the barriers' initialisation visible to the bulk copies.
__device__ inline void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One bulk copy by the tensor memory accelerator, completing on `bar`.
__device__ inline void bulk_copy(float* dst, const float* src,
                                 unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the barrier's first phase: the group's bulk copies landed.
__device__ inline void bar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)) : "memory");
}

// n floats from src to dst, a buffer of make_layout (16-byte aligned).
struct Copy {
  float* dst;
  const float* src;
  int n;
};

// The part of a copy that goes as one bulk copy: whole 16 bytes from an
// aligned source; the rest goes by 4-byte cp.async.
__device__ inline int bulk_floats(const Copy& c) {
  return (reinterpret_cast<uintptr_t>(c.src) & 15) ? 0 : c.n & ~3;
}

// Puts one group of copies in flight: thread 0 expects their bulk bytes on
// `bar` and issues the bulk copies; the block issues the 4-byte rest as
// one cp.async group.
template <int kCount>
__device__ void stage(const Copy (&copies)[kCount], uint64_t* bar) {
  if (threadIdx.x == 0) {
    unsigned bytes = 0;
#pragma unroll
    for (int j = 0; j < kCount; ++j) bytes += 4u * bulk_floats(copies[j]);
    bar_expect(bar, bytes);
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const int nb = bulk_floats(copies[j]);
      if (nb) bulk_copy(copies[j].dst, copies[j].src, 4u * nb, bar);
    }
  }
#pragma unroll
  for (int j = 0; j < kCount; ++j)
    for (int i = bulk_floats(copies[j]) + threadIdx.x; i < copies[j].n;
         i += kThreads)
      cp_async4(copies[j].dst + i, copies[j].src + i);
  cp_commit();
}

__device__ inline float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ inline float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// The block's max (is_max) or sum of v, in a fixed order, in every thread.
__device__ float block_reduce(float v, float* red, bool is_max) {
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // the previous reduction's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// ax (rows x f) = rows row0 .. row0 + kTM of A_hat . X, X (n x f) in
// device memory, staged through xs kKM rows at a time with the matching
// tile of A_hat in as. Ends with a barrier: ax is complete.
__device__ void aggregate(const float* __restrict__ a,
                          const float* __restrict__ x, float* xs, float* as,
                          float* ax, int n, int f, int row0) {
  const int tid = threadIdx.x;
  const int rows = min(kTM, n - row0);
  // every (row, feature) of the tile is owned by one thread for the whole
  // sum, through the same strided mapping in each pass below
  for (int i = tid; i < rows * f; i += kThreads) ax[i] = 0.f;
  for (int m0 = 0; m0 < n; m0 += kKM) {
    const int km = min(kKM, n - m0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < km * f; i += kThreads)
      xs[i] = __ldg(x + static_cast<long long>(m0) * f + i);
    for (int i = tid; i < kTM * kKM; i += kThreads) {
      const int r = i / kKM, c = i % kKM;
      as[i] = (r < rows && c < km)
                  ? __ldg(a + static_cast<long long>(row0 + r) * n + m0 + c)
                  : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < rows * f; i += kThreads) {
      const int r = i / f, c = i % f;
      float s = ax[i];
      for (int k = 0; k < km; ++k) s = fmaf(as[r * kKM + k], xs[k * f + c], s);
      ax[i] = s;
    }
  }
  __syncthreads();
}

template <bool kGlobal>
__device__ inline float load(const float* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

// dst (rows x h, row-major) = relu?(src . w + b): src rows of kd, ld apart,
// in shared memory; w (kd x h) and b (h,; nullptr: none) in device memory
// (kGlobal) or shared memory. Each thread carries R rows of one column.
template <bool kGlobal, int R>
__device__ void product_rows(const float* src, int ld, int rows, int kd,
                             const float* __restrict__ w,
                             const float* __restrict__ b, int h, float* dst,
                             bool relu) {
  const int groups = (rows + R - 1) / R;
  for (int i = threadIdx.x; i < groups * h; i += kThreads) {
    const int r0 = i / h * R, c = i % h;
    const float* s[R];
#pragma unroll
    for (int j = 0; j < R; ++j) s[j] = src + min(r0 + j, rows - 1) * ld;
    float acc[R] = {};
#pragma unroll 4
    for (int k = 0; k < kd; ++k) {
      const float wk = load<kGlobal>(w + static_cast<long long>(k) * h + c);
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] = fmaf(s[j][k], wk, acc[j]);
    }
    const float bc = b ? load<kGlobal>(b + c) : 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (r0 + j < rows) {
        const float v = acc[j] + bc;
        dst[static_cast<long long>(r0 + j) * h + c] = relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

// product_rows with as many rows a thread as there are, up to kRows.
template <bool kGlobal>
__device__ void product(const float* src, int ld, int rows, int kd,
                        const float* w, const float* b, int h, float* dst,
                        bool relu) {
  switch (rows < kRows ? rows : kRows) {
    case 1: product_rows<kGlobal, 1>(src, ld, rows, kd, w, b, h, dst, relu);
      break;
    case 2: product_rows<kGlobal, 2>(src, ld, rows, kd, w, b, h, dst, relu);
      break;
    case 3: product_rows<kGlobal, 3>(src, ld, rows, kd, w, b, h, dst, relu);
      break;
    default:
      product_rows<kGlobal, kRows>(src, ld, rows, kd, w, b, h, dst, relu);
  }
}

// The head's warp partials: part[r][c / 32] = the sum over the 32 hidden
// units c.. of relu([hl[r], hx[r]] . w1[:, c] + b1[c]) . w2[c], R rows a
// thread, all in shared memory. hl rows of hd, hx rows of f; hidden padded
// to hp, a multiple of 32, so a warp's 32 consecutive units share its rows.
template <int R>
__device__ void head_rows(const float* hl, int hd, const float* hx, int f,
                          int n, const float* w1, const float* b1,
                          const float* w2, int hidden, float* part) {
  const int hp = (hidden + 31) & ~31;
  const int segs = hp / 32;
  const int groups = (n + R - 1) / R;
  for (int i = threadIdx.x; i < groups * hp; i += kThreads) {  // whole warps
    const int r0 = i / hp * R, c = i % hp;
    float acc[R] = {};
    if (c < hidden && !(GCN_SKIP & 1)) {
      const float* hr[R];
      const float* xr[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = min(r0 + j, n - 1);
        hr[j] = hl + r * hd;
        xr[j] = hx + r * f;
      }
#pragma unroll 4
      for (int k = 0; k < hd; ++k) {
        const float wk = w1[k * hidden + c];
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j] = fmaf(hr[j][k], wk, acc[j]);
      }
#pragma unroll 4
      for (int k = 0; k < f; ++k) {
        const float wk = w1[(hd + k) * hidden + c];
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j] = fmaf(xr[j][k], wk, acc[j]);
      }
      const float bc = b1[c], wc = w2[c];
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] = fmaxf(acc[j] + bc, 0.f) * wc;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float v = warp_sum(acc[j]);
      if ((threadIdx.x & 31) == 0 && r0 + j < n)
        part[(r0 + j) * segs + c / 32] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gcn_kernel(const float* __restrict__ a, const float* __restrict__ x,
           Layers layers, Head head, Layout lay, float* __restrict__ out,
           int n) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int L = layers.n_layers;
  const int f0 = layers.dim[0];
  const long long bi = blockIdx.y;
  float* ax = smem + lay.ax;
  const float* xg = x + bi * n * f0;

  if (lay.xs >= 0) {  // one layer alone, one row tile a block
    const int h = layers.dim[1], row0 = blockIdx.x * kTM;
    aggregate(a, xg, smem + lay.xs, smem + lay.as, ax, n, f0, row0);
    product<true>(ax, f0, min(kTM, n - row0), f0, layers.w[0], layers.b[0],
                  h, out + (bi * n + row0) * h, layers.relu_last);
    return;
  }

  // the action: the whole graph in this block. Everything it reads goes in
  // flight to shared memory at once, in one group a layer, each group a
  // copy barrier and a cp.async group: X, A_hat, the mask and noise rows
  // with layer 0's weights; then each layer's weights; then the head's.
  constexpr bool kWeights = !(GCN_SKIP & 8);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  if (tid == 0) {
    for (int g = 0; g <= L; ++g) bar_init(bars + g);
    bar_fence_init();
  }
  float* hx = smem + lay.hx;
  float* as = smem + lay.as;
  int hd = f0;  // the last layer's width (dim[L], read at constant indices)
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l < L) {
      const int f = layers.dim[l], h = layers.dim[l + 1];
      const Copy w = {smem + lay.w[l], layers.w[l], kWeights ? f * h : 0};
      const Copy b = {smem + lay.b[l], layers.b[l], kWeights ? h : 0};
      if (l == 0) {
        const Copy copies[6] = {
            {hx, xg, n * f0},
            {as, a, GCN_SKIP & 8 ? 0 : n * n},
            {smem + lay.mask, head.mask + bi * head.mask_bs,
             head.mask ? n : 0},
            {smem + lay.noise, head.noise + bi * head.noise_bs,
             head.noise ? n : 0},
            w, b};
        stage(copies, bars);
      } else {
        const Copy copies[2] = {w, b};
        stage(copies, bars + l);
      }
      hd = h;
    }
  }
  {
    const int hidden = head.hidden;
    const Copy copies[4] = {
        {smem + lay.w1, head.w1, kWeights ? (hd + f0) * hidden : 0},
        {smem + lay.b1, head.b1, kWeights ? hidden : 0},
        {smem + lay.w2, head.w2, kWeights ? hidden : 0},
        {smem + lay.b2, head.b2, kWeights ? 1 : 0}};
    stage(copies, bars + L);
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  const float* in = hx;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l < L) {
      cp_wait(L - l);  // layer l's group has landed: its cp.async part,
      bar_wait(bars + l);  // and its bulk part
      const int f = layers.dim[l], h = layers.dim[l + 1];
      float* dst = smem + ((l & 1) ? lay.h1 : lay.h0);
      for (int row0 = 0; row0 < n; row0 += kTM) {
        const int rows = min(kTM, n - row0);
        __syncthreads();  // in is complete; the last tile is done with ax
        if (!(GCN_SKIP & 4))  // ax = the tile's rows of A_hat . in
          product<false>(as + row0 * n, n, rows, n, in, nullptr, f, ax,
                         false);
        __syncthreads();
        if (!(GCN_SKIP & 2))
          product<false>(ax, f, rows, f, smem + lay.w[l], smem + lay.b[l],
                         h, dst + row0 * h, l < L - 1);
      }
      in = dst;
    }
  }
  cp_wait(0);
  bar_wait(bars + L);
  __syncthreads();  // h_L and the head's weights are in place

  // the head: logit[r] = relu([h_L[r], X[r]] . W1 + b1) . W2 + b2
  const int hidden = head.hidden;
  const int segs = (hidden + 31) / 32;
  const float* w1 = smem + lay.w1;
  const float* b1 = smem + lay.b1;
  const float* w2 = smem + lay.w2;
  float* part = smem + lay.part;
  switch (n < kRows ? n : kRows) {
    case 1: head_rows<1>(in, hd, hx, f0, n, w1, b1, w2, hidden, part); break;
    case 2: head_rows<2>(in, hd, hx, f0, n, w1, b1, w2, hidden, part); break;
    case 3: head_rows<3>(in, hd, hx, f0, n, w1, b1, w2, hidden, part); break;
    default:
      head_rows<kRows>(in, hd, hx, f0, n, w1, b1, w2, hidden, part);
  }
  __syncthreads();
  float* logit = smem + lay.logit;
  const float* mask = smem + lay.mask;
  const float* noise = smem + lay.noise;
  const float b2 = smem[lay.b2];
  float m = -3.402823466e38f;  // -FLT_MAX: below every logit
  for (int r = tid; r < n; r += kThreads) {
    float s = 0.f;
    for (int j = 0; j < segs; ++j) s += part[r * segs + j];
    s += b2;
    if (head.noise) s += noise[r];
    if (head.mask && !(mask[r] > 0.f)) s = -1e9f;
    logit[r] = s;  // each thread keeps its own nodes from here on
    m = fmaxf(m, s);
  }
  if (GCN_SKIP & 16) {
    for (int r = tid; r < n; r += kThreads) out[bi * n + r] = logit[r];
    return;
  }
  float* red = smem + lay.red;
  m = block_reduce(m, red, true);
  float sum = 0.f;
  for (int r = tid; r < n; r += kThreads) {
    const float e = expf(logit[r] - m);
    logit[r] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  for (int r = tid; r < n; r += kThreads) out[bi * n + r] = logit[r] / sum;
}

// Checks the sizes, raises the shared-memory attribute when needed and
// launches: grid (row tiles, batch) for one layer alone, else (1, batch).
int launch(const void* a, const void* x, const Layers& ly, const Head& hd,
           void* out, int batch, int n, void* stream) {
  if (batch < 1 || n < 1 || ly.n_layers < 1 || ly.n_layers > kMaxLayers)
    return -1;
  for (int l = 0; l <= ly.n_layers; ++l)
    if (ly.dim[l] < 1) return -1;
  if (hd.w1 ? hd.hidden < 1 : ly.n_layers != 1) return -1;
  const Layout lay = make_layout(n, ly, hd.w1 ? hd.hidden : 0);
  const size_t smem = static_cast<size_t>(lay.total) * sizeof(float);
  if (smem > kMaxSmem) return -1;
  static size_t attr_set = kDefaultSmem;
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gcn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = kMaxSmem;
  }
  const dim3 grid(lay.xs >= 0 ? (n + kTM - 1) / kTM : 1, batch);
  gcn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x), ly, hd,
      lay, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------- backward
constexpr int kBwdFT = 4;      // rows of dW (input features) a block
constexpr int kBwdRows = 128;  // graph nodes a dW block sums, whole graphs

__host__ __device__ inline int round4(int floats) { return (floats + 3) & ~3; }

// Graphs a dW block sums: whole graphs, up to kBwdRows nodes.
__host__ __device__ inline int bwd_graphs(int n) {
  return n >= kBwdRows ? 1 : kBwdRows / n;
}

// Floats of dynamic shared memory: the dW blocks' A_hat, X and A_hat . X
// tiles and G; the dX blocks' A_hat, G, G . W^T and W (rows padded to
// h + 1, so a warp's 32 rows fall in 32 banks).
inline int bwd_smem_floats(int n, int f, int h, bool with_dx) {
  const int rows = bwd_graphs(n) * n;
  const int wblk = round4(n * n) + 2 * round4(rows * kBwdFT) +
                   round4(rows * h);
  const int xblk = round4(n * n) + round4(n * h) + round4(n * f) +
                   round4(f * (h + 1));
  return with_dx && xblk > wblk ? xblk : wblk;
}

// G at flat index i of (batch, n, h): dH, zeroed where the relu did not pass.
__device__ inline float grad_pre(const float* __restrict__ out,
                                 const float* __restrict__ dh, long long i,
                                 int relu) {
  const float g = __ldg(dh + i);
  return relu && !(__ldg(out + i) > 0.f) ? 0.f : g;
}

// Grid: w_blocks x chunks dW blocks, then (dx) one block a graph. dW block
// (t, c) sums rows 4t .. 4t + 4 of dW (t == 0: and db) over chunk c's
// graphs into part (chunks, f, h) and part_db (chunks, h); the last of a
// tile's blocks to finish -- found by its ticket counter, which it leaves
// zero -- sums the tile's partials in chunk order into dw (and db).
__global__ void __launch_bounds__(kThreads)
gcn_bwd_kernel(const float* __restrict__ a, const float* __restrict__ x,
               const float* __restrict__ w, const float* __restrict__ out,
               const float* __restrict__ dh, float* __restrict__ dx,
               float* __restrict__ dw, float* __restrict__ db,
               float* __restrict__ part, float* __restrict__ part_db,
               int* __restrict__ tickets, int batch, int n, int f, int h,
               int relu, int w_blocks, int chunks) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool merge_s;
  const int tid = threadIdx.x;
  float* as = smem;  // A_hat (n x n)
  for (int i = tid; i < n * n; i += kThreads) as[i] = __ldg(a + i);

  if (static_cast<int>(blockIdx.x) < w_blocks * chunks) {
    const int tile = blockIdx.x % w_blocks, chunk = blockIdx.x / w_blocks;
    const int f0 = tile * kBwdFT, ft = min(kBwdFT, f - f0);
    const int gpc = bwd_graphs(n);
    const int rows = min(gpc, batch - chunk * gpc) * n;
    const long long base = static_cast<long long>(chunk) * gpc * n;
    float* xs = as + round4(n * n);              // (rows, ft) of X
    float* ax = xs + round4(gpc * n * kBwdFT);   // (rows, ft) of A_hat . X
    float* gs = ax + round4(gpc * n * kBwdFT);   // (rows, h) of G
    for (int i = tid; i < rows * ft; i += kThreads) {
      const int r = i / ft, c = i % ft;
      xs[i] = __ldg(x + (base + r) * f + f0 + c);
    }
    for (int i = tid; i < rows * h; i += kThreads)
      gs[i] = grad_pre(out, dh, base * h + i, relu);
    __syncthreads();
    for (int i = tid; i < rows * ft; i += kThreads) {  // graph by graph
      const int r = i / ft, c = i % ft, node = r % n;
      const float* xg = xs + (r - node) * ft;
      float s = 0.f;
      for (int m = 0; m < n; ++m) s = fmaf(as[node * n + m], xg[m * ft + c], s);
      ax[i] = s;
    }
    __syncthreads();
    float* pw = part + (static_cast<long long>(chunk) * f + f0) * h;
    for (int i = tid; i < ft * h; i += kThreads) {  // each entry one thread's
      const int c = i / h, k = i % h;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s = fmaf(ax[r * ft + c], gs[r * h + k], s);
      pw[i] = s;
    }
    if (tile == 0) {
      for (int k = tid; k < h; k += kThreads) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += gs[r * h + k];
        part_db[static_cast<long long>(chunk) * h + k] = s;
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      merge_s = atomicAdd(tickets + tile, 1) == chunks - 1;
      if (merge_s) tickets[tile] = 0;  // every chunk of the tile is in
    }
    __syncthreads();
    if (!merge_s) return;
    __threadfence();
    for (int i = tid; i < ft * h; i += kThreads) {  // in chunk order
      float s = 0.f;
      for (int c = 0; c < chunks; ++c)
        s += __ldcg(part + (static_cast<long long>(c) * f + f0) * h + i);
      dw[static_cast<long long>(f0) * h + i] = s;
    }
    if (tile == 0) {
      for (int k = tid; k < h; k += kThreads) {
        float s = 0.f;
        for (int c = 0; c < chunks; ++c)
          s += __ldcg(part_db + static_cast<long long>(c) * h + k);
        db[k] = s;
      }
    }
    return;
  }

  // dX of one graph: A_hat^T . (G . W^T)
  const long long bi = blockIdx.x - static_cast<long long>(w_blocks) * chunks;
  float* gs = as + round4(n * n);  // (n, h) of G
  float* ts = gs + round4(n * h);  // (n, f) of G . W^T
  float* ws = ts + round4(n * f);  // (f, h + 1) of W
  for (int i = tid; i < n * h; i += kThreads)
    gs[i] = grad_pre(out, dh, bi * n * h + i, relu);
  for (int i = tid; i < f * h; i += kThreads)  // coalesced, then padded
    ws[i / h * (h + 1) + i % h] = __ldg(w + i);
  __syncthreads();
  for (int i = tid; i < n * f; i += kThreads) {
    const int r = i / f, c = i % f;
    const float* wr = ws + c * (h + 1);
    float s = 0.f;
    for (int k = 0; k < h; ++k) s = fmaf(gs[r * h + k], wr[k], s);
    ts[i] = s;
  }
  __syncthreads();
  float* dxg = dx + bi * n * f;
  for (int i = tid; i < n * f; i += kThreads) {
    const int r = i / f, c = i % f;
    float s = 0.f;
    for (int m = 0; m < n; ++m) s = fmaf(as[m * n + r], ts[m * f + c], s);
    dxg[i] = s;
  }
}

}  // namespace

extern "C" {

// One layer. a (n, n), x (batch, n, f), w (f, h), b (h,), out
// (batch, n, h): contiguous f32 device pointers. Returns 0, a CUDA error
// code from the attribute call or the launch, or -1 for unsupported sizes
// (a zero dimension, or F too wide for one block's shared memory).
int gcn_layer_launch(const void* a, const void* x, const void* w,
                     const void* b, void* out, int batch, int n, int f, int h,
                     int relu, void* stream) {
  Layers ly = {};
  ly.w[0] = static_cast<const float*>(w);
  ly.b[0] = static_cast<const float*>(b);
  ly.dim[0] = f;
  ly.dim[1] = h;
  ly.n_layers = 1;
  ly.relu_last = relu;
  return launch(a, x, ly, Head{}, out, batch, n, stream);
}

// The actor's action. a (n, n), x (batch, n, dims[0]); w[l]
// (dims[l], dims[l + 1]) and b[l] (dims[l + 1],) for l < n_layers; w1
// (dims[n_layers] + dims[0], hidden), b1 (hidden,), w2 (hidden, 1), b2
// (1,); noise and mask null or rows of n, *_bs apart; out (batch, n).
// Contiguous f32 device pointers. Returns as gcn_layer_launch; -1 also for
// more than 4 layers or a graph too large for one block's shared memory.
int gcn_actor_launch(const void* a, const void* x, const void* const* w,
                     const void* const* b, const int* dims, int n_layers,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, int hidden, const void* noise,
                     int noise_bs, const void* mask, int mask_bs, void* out,
                     int batch, int n, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || w1 == nullptr) return -1;
  Layers ly = {};
  for (int l = 0; l < n_layers; ++l) {
    ly.w[l] = static_cast<const float*>(w[l]);
    ly.b[l] = static_cast<const float*>(b[l]);
  }
  for (int l = 0; l <= n_layers; ++l) ly.dim[l] = dims[l];
  ly.n_layers = n_layers;
  Head hd = {};
  hd.w1 = static_cast<const float*>(w1);
  hd.b1 = static_cast<const float*>(b1);
  hd.w2 = static_cast<const float*>(w2);
  hd.b2 = static_cast<const float*>(b2);
  hd.noise = static_cast<const float*>(noise);
  hd.mask = static_cast<const float*>(mask);
  hd.hidden = hidden;
  hd.noise_bs = noise_bs;
  hd.mask_bs = mask_bs;
  return launch(a, x, ly, hd, out, batch, n, stream);
}

// The backward of one layer. a (n, n), x (batch, n, f), w (f, h), out and
// dh (batch, n, h): the forward's output and its gradient; dw (f, h), db
// (h,) and dx (batch, n, f) or null (no gradient of x); part (chunks, f, h)
// and part_db (chunks, h) scratch, chunks = ceil(batch / max(1, 128 / n));
// tickets: ceil(f / 4) int32 zeros, left zero. Contiguous f32 device
// pointers. relu: the layer applied its relu. Returns as gcn_layer_launch.
int gcn_layer_bwd_launch(const void* a, const void* x, const void* w,
                         const void* out, const void* dh, void* dx, void* dw,
                         void* db, void* part, void* part_db, void* tickets,
                         int batch, int n, int f, int h, int relu,
                         void* stream) {
  if (batch < 1 || n < 1 || f < 1 || h < 1) return -1;
  const size_t smem =
      static_cast<size_t>(bwd_smem_floats(n, f, h, dx != nullptr)) *
      sizeof(float);
  if (smem > kMaxSmem) return -1;
  static size_t attr_set = kDefaultSmem;
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gcn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = kMaxSmem;
  }
  const int w_blocks = (f + kBwdFT - 1) / kBwdFT;
  const int chunks = (batch + bwd_graphs(n) - 1) / bwd_graphs(n);
  const int blocks = w_blocks * chunks + (dx ? batch : 0);
  gcn_bwd_kernel<<<blocks, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<const float*>(out),
      static_cast<const float*>(dh), static_cast<float*>(dx),
      static_cast<float*>(dw), static_cast<float*>(db),
      static_cast<float*>(part), static_cast<float*>(part_db),
      static_cast<int*>(tickets), batch, n, f, h, relu, w_blocks, chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* gcn_layer_error_string(int code) {
  return code < 0 ? "unsupported sizes (a zero dimension, more than 4 "
                    "layers, or a graph above the shared-memory limit)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
