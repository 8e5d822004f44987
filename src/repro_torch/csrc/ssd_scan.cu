// SSD blocked scan for Hopper (sm_90a): the Mamba-2 state-space-duality
// scan of one prefill, for every (batch row, head), from a zero state or
// from a carried one (a chunked prefill continues the state its earlier
// chunks left).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py. It computes the same function: per head
// h, with the (P, N) state carried across blocks of steps,
//   y[q]   = sum_{k<=q} exp(a_cum[q] - a_cum[k]) (C[q].B[k]) x[k]
//            + exp(a_cum[q]) C[q].state
//   state' = exp(a_cum[Q-1]) state
//            + sum_k exp(a_cum[Q-1] - a_cum[k]) x[k] B[k]^T
// with a_cum the running sum of the log decays a over the block. The TPU
// kernel's sequential chunk grid axis becomes a loop inside one block. The
// SSD decomposition is exact for any block length, so the result is the
// reference's at any `chunk` up to f32 rounding. A ragged last block is
// masked: zero a, B, C and x are a decay of 1 and no input, so inert.
//
// Bound: operations. A block of Q steps does Q^2 N / 2 multiply-adds for
// C.B^T per batch row and Q^2 P / 2 + 2 Q P N per head, for Q (P + 2 N)
// loaded values, far above the card's operations-per-byte ratio at P 64,
// N 128. So every product runs on the tensor cores:
//
// * Split TF32 ("3xTF32"). The contract is f32 in and out at the
//   reference's 1e-4, which one TF32 pass misses (its 10-bit mantissa
//   leaves ~5e-3 in y). Each f32 operand v is split in registers into
//   hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest with ties
//   away from zero -- the bits of `cvt.rna.tf32.f32`, computed by an
//   integer add and mask, because ptxas expands the cvt into a
//   compare-and-select sequence that cost a third of the kernel's time --
//   and each product is lo.hi + hi.lo + hi.hi with f32 accumulation, as
//   `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` on fragments
//   loaded from shared memory (ref.ssd_scan_tiled_ref is this arithmetic
//   in plain PyTorch).
// * The tile sized to T. The step tile Q is a template over {16, 32} (the
//   m16 granule): 16 for the control loop's fleet prefills (T <= 16), 32
//   beyond, walking blocks of 32 (a tile of 64 measured slower at the
//   drain bucket: one block an SM, and its diagonal term grows with Q).
// * C.B^T once for several heads. A block serves HPB (1 or 2) heads of one
//   batch row; the masked score tile S = C.B^T is computed once into
//   shared memory (only its causal 16 x 8 tiles), and each head applies
//   its own decay exp(a_cum[q] - a_cum[k]) to it elementwise as it loads
//   its fragments. The decay is never factored into exp(a_cum[q]) .
//   exp(-a_cum[k]): a_cum reaches about -100 over 64 steps and exp(100)
//   overflows f32.
// * The state in registers. Four warps serve a head, each owning 16 rows
//   of p and all N columns of the state: NT n8 tiles, a template (8 for
//   N <= 64, 16 for N <= 128), so zamba2's state takes half the registers
//   of mamba2's, and every shared-memory offset in the products is a
//   constant. The state update x_w^T.B accumulates straight into them,
//   and the state's term of y is computed transposed, y^T = state.C^T
//   (+ x^T.L^T for the diagonal term), with the state's accumulator
//   registers as the A fragment. An m16n8 accumulator holds columns 2t,
//   2t+1 where an m16k8 A fragment holds t, t+4; since the k index of a
//   product is summed over, the kernel permutes it (logical k t <-> n 2t,
//   t+4 <-> 2t+1) on both operands, so no shuffle is needed. C.B^T uses
//   the same permutation, so its C and B fragments are 8-byte loads.
// * Loads overlapped with compute. The next block's C, B, x and a move by
//   16-byte `cp.async` (4-byte where a row is not 16-byte aligned) into
//   the other of two stages while this block is multiplied.
//
// Shared memory rows are padded so that every fragment load is free of
// bank conflicts: C, B and x rows by 8 floats past a multiple of 32, the
// score tile by 4. x rows are 64 wide and C, B rows 8 NT wide whatever P
// and N are; the columns past them are zeroed once and never written.
//
// The initial state. With `init` (B, H, P, N) given, the registers that
// hold the state are loaded from it before the first block instead of
// zeroed, and the first block adds the state's term of y as every later
// block does; the TPU kernel always starts from zero, the reference's
// `ssd_chunked(..., init_state=)` is the function. `init` may be the
// `state` output itself (the state is read before anything is written).
//
// Layout, all f32 and contiguous: x (B, T, H, P) dt-preweighted, a
// (B, T, H) log decays (<= 0, so every exponent is <= 0), Bm / Cm
// (B, T, N) (one group), y (B, T, H, P), state and init (B, H, P, N).
// Grid: (ceil(H / HPB), B), 128 x HPB threads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Time breakdown builds (tools/ssd_breakdown.py); a build with a part left
// out computes garbage. SSD_SKIP bits leave out 1: the state's term of y,
// 2: the diagonal term, 4: the state update, 8: C.B^T, 16: the lo passes
// (one TF32 pass). SSD_SPLIT 1 splits by `cvt.rna.tf32.f32` (the same
// bits as the default), 2 leaves lo to the tensor core's truncation of
// its low 13 bits.
#ifndef SSD_SKIP
#define SSD_SKIP 0
#endif
#ifndef SSD_SPLIT
#define SSD_SPLIT 0
#endif

namespace {

constexpr int kMaxP = 64;   // head dim: four warps of 16 rows a head
constexpr int kMaxN = 128;  // state dim: at most 16 n8 tiles
constexpr int kWarpsPerHead = kMaxP / 16;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared memory of one instantiation, in floats: two stages of C [Q][NS],
// B [Q][NS], x [HPB][Q][XS] and a [HPB][Q], then the score tile [Q][SS].
// Row strides sit 8 floats past a multiple of 32 for C, B and x (their
// fragments read 8 rows x 4 columns or 4 rows x 8 columns) and 4 past one
// for the score tile (8 rows x 4 columns).
template <int Q, int HPB, int NT>
struct Layout {
  static constexpr int NS = round_up(8 * NT, 32) + 8;
  static constexpr int XS = kMaxP + 8;
  static constexpr int SS = round_up(Q, 32) + 4;
  static constexpr int B0 = Q * NS;                  // B after C
  static constexpr int X0 = 2 * Q * NS;              // then x
  static constexpr int A0 = X0 + HPB * Q * XS;       // then a
  static constexpr int STAGE = A0 + HPB * Q;
  static constexpr int FLOATS = 2 * STAGE + Q * SS;
};
static_assert(Layout<32, 2, 16>::FLOATS * 4 <= 232448,
              "the largest instantiation must fit a block's shared memory");

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
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool ok, bool vec) {
  if (vec)
    cp_async16(smem, gmem, ok);
  else
    cp_async4(smem, gmem, ok);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tf32(v) rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds a finite value: add half a TF32 step to the bits, clear the low 13
__device__ __forceinline__ uint32_t rna_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
// v = hi + lo to about 22 bits (the difference v - hi is exact in f32)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
#if SSD_SPLIT == 1
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
#else
  hi = rna_bits(v);
  const float r = v - __uint_as_float(hi);
  lo = SSD_SPLIT == 2 ? __float_as_uint(r) : rna_bits(r);
#endif
}
// the two values at p, p + 1, split
__device__ __forceinline__ void split2(const float* p, uint32_t* hi,
                                       uint32_t* lo) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split(v.x, hi[0], lo[0]);
  split(v.y, hi[1], lo[1]);
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b at f32 accuracy: the two small cross terms first, then hi.hi
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  if (!(SSD_SKIP & 16)) {
    mma(d, al, bh);
    mma(d, ah, bl);
  }
  mma(d, ah, bh);
}

// Issue the copies of one block of steps (rows row0 .. row0 + nq - 1 of
// the (B*T) axis; rows nq .. Q - 1 are zero-filled) into stage `st`. Each
// thread keeps one column of a row and walks the rows.
template <int Q, int HPB, int NT>
__device__ __forceinline__ void load_block(
    float* st, const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    long long row0, int nq, int h0, int nh, int H, int P, int N, bool vec,
    int tid) {
  using L = Layout<Q, HPB, NT>;
  constexpr int kThreads = 32 * kWarpsPerHead * HPB;
  const int w = vec ? 4 : 1;  // floats a copy
  {
    const int nw = N / w, rstep = kThreads / nw;  // nw <= 128 <= kThreads
    const int r0 = tid / nw, c = (tid - r0 * nw) * w;
    for (int r = r0; r0 < rstep && r < Q; r += rstep) {
      const bool ok = r < nq;
      const long long gi = ok ? (row0 + r) * N + c : 0;
      cp_async(st + r * L::NS + c, Cm + gi, ok, vec);
      cp_async(st + L::B0 + r * L::NS + c, Bm + gi, ok, vec);
    }
  }
  {
    const int pw = P / w, rstep = kThreads / pw;
    const int r0 = tid / pw, c = (tid - r0 * pw) * w;
    for (int hr = r0; r0 < rstep && hr < HPB * Q; hr += rstep) {
      const int hh = hr / Q, r = hr % Q;
      const bool ok = r < nq && hh < nh;
      const long long gi = ok ? ((row0 + r) * H + h0 + hh) * P + c : 0;
      cp_async(st + L::X0 + hr * L::XS + c, x + gi, ok, vec);
    }
  }
  for (int i = tid; i < HPB * Q; i += kThreads) {
    const int hh = i / Q, r = i % Q;
    const bool ok = r < nq && hh < nh;
    cp_async4(st + L::A0 + i, a + (ok ? (row0 + r) * H + h0 + hh : 0), ok);
  }
}

template <int Q, int HPB, int NT>
__global__ void __launch_bounds__(32 * kWarpsPerHead * HPB, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* init, float* state, float* __restrict__ y,
                int T, int H, int P, int N, int vec) {
  using L = Layout<Q, HPB, NT>;
  constexpr int kThreads = 32 * kWarpsPerHead * HPB;
  constexpr int kQT = Q / 8;              // n8 / k8 tiles of steps
  constexpr int kMT = Q / 16;             // m16 tiles of steps
  constexpr int kScoreTiles = kMT * (kMT + 1);  // causal 16 x 8 tiles
  constexpr int NS = L::NS, XS = L::XS, SS = L::SS;

  extern __shared__ __align__(16) float smem[];
  float* S_s = smem + 2 * L::STAGE;       // [Q][SS], masked C.B^T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int b = blockIdx.y, h0 = blockIdx.x * HPB;
  const int nh = min(HPB, H - h0);
  const int hh = warp / kWarpsPerHead;    // this warp's head in the block
  const int p0 = (warp % kWarpsPerHead) * 16;  // and its 16 rows of p
  const bool busy = hh < nh && p0 < P;
  const int h = h0 + hh;

  if (N != 8 * NT || P != kMaxP) {  // padding columns are read: zero them
    for (int i = tid * 4; i < L::FLOATS; i += kThreads * 4)
      *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  // state rows p0 + g (regs 0, 1) and p0 + g + 8 (2, 3), columns
  // n = 8j + 2t (0, 2) and 8j + 2t + 1 (1, 3)
  float st[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) st[j][r] = 0.f;
  if (init != nullptr && busy) {  // the carried state, in the same registers
    const float* sb = init + ((long long)b * H + h) * P * N;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pr = p0 + g + 8 * (r >> 1), n = 8 * j + 2 * t + (r & 1);
        if (pr < P && n < N) st[j][r] = sb[pr * N + n];
      }
  }

  const long long rowb = (long long)b * T;
  const int n_blocks = (T + Q - 1) / Q;
  load_block<Q, HPB, NT>(smem, x, a, Bm, Cm, rowb, min(Q, T), h0, nh, H, P,
                         N, vec, tid);
  cp_async_commit();

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int t0 = blk * Q, nq = min(Q, T - t0);
    if (blk + 1 < n_blocks)
      load_block<Q, HPB, NT>(smem + ((blk + 1) & 1) * L::STAGE, x, a, Bm,
                             Cm, rowb + t0 + Q, min(Q, T - t0 - Q), h0, nh,
                             H, P, N, vec, tid);
    cp_async_commit();      // (an empty group on the last block)
    cp_async_wait<1>();     // this block's copies have landed
    __syncthreads();

    const float* C_s = smem + (blk & 1) * L::STAGE;
    const float* B_s = C_s + L::B0;
    const float* x_s = C_s + L::X0;
    float* ac_s = smem + (blk & 1) * L::STAGE + L::A0;  // a, then a_cum

    if (warp < nh) {  // inclusive prefix sum of a, one warp a head
      float* ah = ac_s + warp * Q;
      float s0 = lane < Q ? ah[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s0, o);
        if (lane >= o) s0 += u;
      }
      if (lane < Q) ah[lane] = s0;
    }

    // S[q][k] = k <= q ? C[q].B[k] : 0 over the causal 16 x 8 tiles, the
    // n index permuted (logical k t <-> n 8j + 2t, t + 4 <-> 8j + 2t + 1)
    for (int tile = warp; tile < kScoreTiles && !(SSD_SKIP & 8);
         tile += kThreads / 32) {
      int mt = 0;
      while ((mt + 1) * (mt + 2) <= tile) ++mt;
      const int kt = tile - mt * (mt + 1);
      const float* ca = C_s + (16 * mt + g) * NS + 2 * t;
      const float* bb = B_s + (8 * kt + g) * NS + 2 * t;
      // two accumulators (even and odd n tiles) halve the chain of
      // dependent mma
      float d[2][4] = {};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t u[2], ul[2], v[2], vl[2], bh[2], bl[2];
        split2(ca + 8 * j, u, ul);
        split2(ca + 8 * NS + 8 * j, v, vl);
        split2(bb + 8 * j, bh, bl);
        const uint32_t ah[4] = {u[0], v[0], u[1], v[1]};
        const uint32_t al[4] = {ul[0], vl[0], ul[1], vl[1]};
        mma3(d[j & 1], ah, al, bh, bl);
      }
      const int q = 16 * mt + g, k = 8 * kt + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          S_s[(q + 8 * i) * SS + k + c] =
              k + c <= q + 8 * i ? d[0][2 * i + c] + d[1][2 * i + c] : 0.f;
    }
    __syncthreads();

    if (busy) {
      const float* xh = x_s + hh * Q * XS + p0 + g;  // x[k][p0 + g]
      const float* ah = ac_s + hh * Q;
      // y^T rows p0 + g (+ 8), columns q = 8 qt + 2t (+ 1)
      float acc[kQT][4];
#pragma unroll
      for (int qt = 0; qt < kQT; ++qt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[qt][r] = 0.f;

      // the state's term: state . C^T (a zero state adds nothing to the
      // first block)
      if ((blk > 0 || init != nullptr) && !(SSD_SKIP & 1)) {
        const float* cq = C_s + g * NS + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t sh[4], sl[4];
          split(st[j][0], sh[0], sl[0]);
          split(st[j][2], sh[1], sl[1]);
          split(st[j][1], sh[2], sl[2]);
          split(st[j][3], sh[3], sl[3]);
#pragma unroll
          for (int qt = 0; qt < kQT; ++qt) {
            uint32_t bh[2], bl[2];
            split2(cq + 8 * qt * NS + 8 * j, bh, bl);
            mma3(acc[qt], sh, sl, bh, bl);
          }
        }
#pragma unroll
        for (int qt = 0; qt < kQT; ++qt) {
          const int q = 8 * qt + 2 * t;
          const float e0 = __expf(ah[q]), e1 = __expf(ah[q + 1]);
          acc[qt][0] *= e0;
          acc[qt][1] *= e1;
          acc[qt][2] *= e0;
          acc[qt][3] *= e1;
        }
      }

      // the diagonal term: x^T . L^T, L[q][k] = exp(a_cum[q] - a_cum[k]) S
      // (S is 0 above the diagonal; only the diagonal tile masks the exp)
#pragma unroll
      for (int ks = 0; ks < kQT; ++ks) {
        if (8 * ks >= nq || (SSD_SKIP & 2)) break;
        const int k0 = 8 * ks + t, k1 = k0 + 4;
        uint32_t xa[4], xl[4];
        split(xh[k0 * XS], xa[0], xl[0]);
        split(xh[k0 * XS + 8], xa[1], xl[1]);
        split(xh[k1 * XS], xa[2], xl[2]);
        split(xh[k1 * XS + 8], xa[3], xl[3]);
        const float a0 = ah[k0], a1 = ah[k1];
#pragma unroll
        for (int qt = ks; qt < kQT; ++qt) {
          const int q = 8 * qt + g;
          const float aq = ah[q];
          const float* sq = S_s + q * SS;
          float e0 = aq - a0, e1 = aq - a1;
          if (qt == ks) {  // k > q: S is 0 and the exponent may be > 0
            e0 = fminf(e0, 0.f);
            e1 = fminf(e1, 0.f);
          }
          uint32_t bh[2], bl[2];
          split(sq[k0] * __expf(e0), bh[0], bl[0]);
          split(sq[k1] * __expf(e1), bh[1], bl[1]);
          mma3(acc[qt], xa, xl, bh, bl);
        }
      }

      const int p = p0 + g;
      const long long HP = (long long)H * P;
      float* yb = y + (rowb + t0) * HP + (long long)h * P + p;
#pragma unroll
      for (int qt = 0; qt < kQT; ++qt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = 8 * qt + 2 * t + c;
          if (q >= nq) continue;
          if (p < P) yb[q * HP] = acc[qt][c];
          if (p + 8 < P) yb[q * HP + 8] = acc[qt][2 + c];
        }
      }

      // state = exp(a_last) state + (x w)^T . B, w[k] = exp(a_last -
      // a_cum[k]); pad steps add 0 to a_last
      const float a_last = ah[Q - 1];
      const float dl = __expf(a_last);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[j][r] *= dl;
      const float* bk = B_s + t * NS + g;
#pragma unroll
      for (int ks = 0; ks < kQT; ++ks) {
        if (8 * ks >= nq || (SSD_SKIP & 4)) break;
        const int k0 = 8 * ks + t, k1 = k0 + 4;
        const float w0 = __expf(a_last - ah[k0]);
        const float w1 = __expf(a_last - ah[k1]);
        uint32_t xa[4], xl[4];
        split(xh[k0 * XS] * w0, xa[0], xl[0]);
        split(xh[k0 * XS + 8] * w0, xa[1], xl[1]);
        split(xh[k1 * XS] * w1, xa[2], xl[2]);
        split(xh[k1 * XS + 8] * w1, xa[3], xl[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh[2], bl[2];
          split(bk[8 * ks * NS + 8 * j], bh[0], bl[0]);
          split(bk[(8 * ks + 4) * NS + 8 * j], bh[1], bl[1]);
          mma3(st[j], xa, xl, bh, bl);
        }
      }
    }
    __syncthreads();  // this stage and S_s are free for the next block
  }

  if (busy) {
    float* sb = state + ((long long)b * H + h) * P * N;
    const int p = p0 + g;
    // columns n, n + 1 side by side: one 8-byte store where N is even
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pr = p + 8 * i;
        if (pr >= P || n >= N) continue;
        float* dst = sb + pr * N + n;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(st[j][2 * i], st[j][2 * i + 1]);
        } else {
          dst[0] = st[j][2 * i];
          if (n + 1 < N) dst[1] = st[j][2 * i + 1];
        }
      }
    }
  }
}

template <int Q, int HPB, int NT>
int set_smem_attribute() {
  // once per instantiation (each is its own function)
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<Q, HPB, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<Q, HPB, NT>::FLOATS * static_cast<int>(sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  return 0;
}

template <int Q_, int HPB_, int NT_>
struct Inst {
  static constexpr int Q = Q_, HPB = HPB_, NT = NT_;
  static constexpr int kThreads = 32 * kWarpsPerHead * HPB_;
  static constexpr int kSmem = Layout<Q_, HPB_, NT_>::FLOATS * 4;
};

// f(Inst<Q, HPB, NT>{}) for the instantiation of (tile, hpb) at state dim
// N (NT = 8 n8 tiles for N <= 64, 16 beyond); -1 if there is none
template <class F>
long long dispatch(int tile, int hpb, int N, F f) {
  if (N < 1 || N > kMaxN) return -1;
  const int nt = N <= 64 ? 8 : 16;
#define SSD_CASE(Q, HPB, NT) \
  if (tile == Q && hpb == HPB && nt == NT) return f(Inst<Q, HPB, NT>{});
  SSD_CASE(16, 1, 8)
  SSD_CASE(16, 2, 8)
  SSD_CASE(32, 1, 8)
  SSD_CASE(32, 2, 8)
  SSD_CASE(16, 1, 16)
  SSD_CASE(16, 2, 16)
  SSD_CASE(32, 1, 16)
  SSD_CASE(32, 2, 16)
#undef SSD_CASE
  return -1;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x, y (B, T, H, P); a (B, T, H); Bm, Cm (B, T, N); state and init
// (B, H, P, N); all f32 and contiguous. `init` is the initial state, or
// null for zeros. `tile` (16 or 32) is the step tile Q and `hpb` (1 or 2)
// the heads a block serves (kernels/ssd_scan.py `plan` picks both).
// Returns 0, a CUDA error code from the attribute call or the launch, or
// -1 for an unsupported shape, tile or hpb.
int ssd_scan_launch(const void* x, const void* a, const void* Bm,
                    const void* Cm, const void* init, void* y, void* state,
                    int B, int T, int H, int P, int N, int tile, int hpb,
                    void* stream) {
  if (B < 1 || T < 1 || H < 1 || P < 1 || P > kMaxP || B > 65535) return -1;
  const int vec = N % 4 == 0 && P % 4 == 0 && aligned16(x) &&
                  aligned16(Bm) && aligned16(Cm);
  return static_cast<int>(dispatch(tile, hpb, N, [&](auto inst) {
    using I = decltype(inst);
    const int e = set_smem_attribute<I::Q, I::HPB, I::NT>();
    if (e) return static_cast<long long>(e);
    ssd_scan_kernel<I::Q, I::HPB, I::NT>
        <<<dim3((H + I::HPB - 1) / I::HPB, B), I::kThreads, I::kSmem,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(x), static_cast<const float*>(a),
            static_cast<const float*>(Bm), static_cast<const float*>(Cm),
            static_cast<const float*>(init), static_cast<float*>(state),
            static_cast<float*>(y), T, H, P, N, vec);
    return static_cast<long long>(cudaGetLastError());
  }));
}

// Dynamic shared memory of one launch of (tile, hpb) at state dim N, in
// bytes; -1 for an unsupported tile, hpb or N.
long long ssd_scan_smem_bytes(int tile, int hpb, int N) {
  return dispatch(tile, hpb, N, [](auto inst) {
    return static_cast<long long>(decltype(inst)::kSmem);
  });
}

// Blocks of (tile, hpb) at state dim N that one SM of the current device
// holds at once (its registers and shared memory decide); -1 for an
// unsupported tile, hpb or N, minus a CUDA error code on failure.
int ssd_scan_blocks_per_sm(int tile, int hpb, int N) {
  return static_cast<int>(dispatch(tile, hpb, N, [](auto inst) {
    using I = decltype(inst);
    int e = set_smem_attribute<I::Q, I::HPB, I::NT>();
    int n = 0;
    if (!e)
      e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, ssd_scan_kernel<I::Q, I::HPB, I::NT>, I::kThreads, I::kSmem));
    return static_cast<long long>(e ? -e : n);
  }));
}

const char* ssd_scan_error_string(int code) {
  return code < 0 ? "unsupported shape (head dim <= 64, state dim <= 128), "
                    "tile (16, 32) or heads a block (1, 2)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
