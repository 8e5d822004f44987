// Mamba-2 decode step for Hopper (sm_90a): one recurrence step of every
// (batch row, head) of a layer's carried SSM state, in one pass over it.
//
// Replaces no TPU kernel: the reference's decode step
// (src/repro/models/ssd.py `ssd_decode_step`) is plain jnp, and so was the
// port's until this kernel; its plain version is kernels/ref.py
// `ssd_decode_ref`. Per row b and head h, with the (P, N) f32 state s and
// the single B/C group:
//   decay     = exp(dt[b,h] A[h])
//   s'[p, n]  = s[p, n] decay + (x[b,h,p] dt[b,h]) B[b,n]
//   y[b,h,p]  = sum_n s'[p, n] C[b,n]
// s' is stored only for the rows the caller writes (`write`, or all).
//
// Bound: bytes. The state is 4 P N bytes a (row, head), 32 KB at P 64,
// N 128 (2.1 MB a row over mamba2-1.3b's 64 heads), against about 5 P N
// operations; x, dt, B and C add a few hundred bytes. The plain version
// makes seven (every row written) to ten (some rows) passes over
// state-sized tensors: the decay product, the materialised input term, the
// sum, the gather and the index_put of the written rows, the read-out. This
// kernel reads each state element once, writes it once where its row is
// written, and keeps everything between in registers.
//
// Design. One block a (row, head). A lane holds four consecutive n, so
// `lanes`, the smallest power of two with 4 lanes >= N, cover one p row, and
// a warp covers 32 / lanes p rows at once: one at N 128, two at N 64 (half
// a warp each), eight at the reduced configs' N 16. The block has as many
// warps as its p rows need, at most eight, and a thread holds ITERS p rows
// (8 at P 64, N 128; 4 at P 64, N 64; 1 at P 32, N 16). Every thread issues
// all its state loads (streaming, evict-first: nothing reads the state
// again in this step) before any arithmetic. y's sum over n: four products
// in a lane, then a butterfly over the lanes of its p row. Any P <= 64 and
// N <= 128 (what ssd_scan takes): the loads and stores are 16 bytes wide
// where N % 4 == 0 and the state's rows and heads are 16-byte aligned
// (VEC), else a float each; lanes past N and rows past P hold zeros and
// store nothing.
//
// Rounding. The state update is the plain version's bit for bit: separate
// round-to-nearest products and sum (__fmul_rn, __fadd_rn: no FMA
// contraction), x widened to f32 before x dt, as PyTorch's type promotion
// does, and exp by expf (not __expf, no fast math), which is what PyTorch's
// CUDA exp computes for a float. Only y's order of summation differs.
//
// Rows written. `write` (n int32 slab rows, duplicates allowed: the fleet
// pads its fixed-length buffer by repeating it) becomes a (B,) byte mask in
// `mask` by a one-block kernel launched first on the same stream; a null
// `write` writes every row. Rows outside it keep their state bit for bit.
//
// Layout: state (B, H, P, N) f32, (P, N) contiguous, row and head strides
// given (a head block of a split state works); x (B, H, P) bf16 or f32, P
// contiguous, strides given; dt (B, H) f32, strides given; A (H,) f32
// contiguous; Bm, Cm (B, N) of the one group in x's dtype, N contiguous,
// row strides given; y (B, H, P) f32 contiguous. Grid: B H blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;        // four n a lane, 32 lanes a p row
constexpr int kMaskThreads = 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float step(float s, float decay, float xdt,
                                      float b) {
  return __fadd_rn(__fmul_rn(s, decay), __fmul_rn(xdt, b));
}

// The state values s[0..4), of which the first n (>= 1) exist; zeros past.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* s, int n) {
  if (VEC) return __ldcs(reinterpret_cast<const float4*>(s));
  float4 v = make_float4(__ldcs(s), 0.f, 0.f, 0.f);
  if (n > 1) v.y = __ldcs(s + 1);
  if (n > 2) v.z = __ldcs(s + 2);
  if (n > 3) v.w = __ldcs(s + 3);
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* s, float4 w, int n) {
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(s), w);
    return;
  }
  __stcs(s, w.x);
  if (n > 1) __stcs(s + 1, w.y);
  if (n > 2) __stcs(s + 2, w.z);
  if (n > 3) __stcs(s + 3, w.w);
}

template <int ITERS, bool VEC, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    ssd_decode_kernel(float* __restrict__ state, long long s_b,
                      long long s_h, const T* __restrict__ x, long long x_b,
                      long long x_h, const float* __restrict__ dt,
                      long long dt_b, long long dt_h,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      long long b_b, const T* __restrict__ Cm, long long c_b,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ y, int H, int P, int N,
                      int lanes_log2) {
  const int lanes = 1 << lanes_log2;         // lanes over one p row
  const int rows = 32 >> lanes_log2;         // p rows a warp covers at once
  const int warps = blockDim.x / 32;

  const long long b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = lane & (lanes - 1), n0 = col * 4;
  const int sub = lane >> lanes_log2;
  const int nv = N - n0;                     // n of this lane (4 or fewer)
  float* s = state + b * s_b + h * s_h;

  float4 v[ITERS];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int p = (i * warps + warp) * rows + sub;
    v[i] = nv > 0 && p < P ? load4<VEC>(s + p * N + n0, nv)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float dtv = dt[b * dt_b + h * dt_h];
  const float decay = expf(__fmul_rn(dtv, A[h]));
  float bv[4], cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bv[j] = j < nv ? widen(Bm[b * b_b + n0 + j]) : 0.f;
    cv[j] = j < nv ? widen(Cm[b * c_b + n0 + j]) : 0.f;
  }
  const bool write = mask == nullptr || mask[b] != 0;
  const T* xr = x + b * x_b + h * x_h;
  float* yr = y + (b * H + h) * P;

#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int p = (i * warps + warp) * rows + sub;
    const bool live = nv > 0 && p < P;
    const float xdt = live ? __fmul_rn(widen(xr[p]), dtv) : 0.f;
    float4 w;
    w.x = step(v[i].x, decay, xdt, bv[0]);
    w.y = step(v[i].y, decay, xdt, bv[1]);
    w.z = step(v[i].z, decay, xdt, bv[2]);
    w.w = step(v[i].w, decay, xdt, bv[3]);
    float acc = w.x * cv[0] + w.y * cv[1] + w.z * cv[2] + w.w * cv[3];
    for (int o = lanes / 2; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (live && write) store4<VEC>(s + p * N + n0, w, nv);
    if (col == 0 && p < P) yr[p] = acc;
  }
}

// mask[r] = 1 for every r in write[0..n), else 0; one block.
__global__ void __launch_bounds__(kMaskThreads)
    ssd_decode_mask_kernel(const int* __restrict__ write, int n,
                           unsigned char* __restrict__ mask, int B) {
  for (int r = threadIdx.x; r < B; r += kMaskThreads) mask[r] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kMaskThreads) {
    const int r = write[i];
    if (r >= 0 && r < B) mask[r] = 1;
  }
}

struct Args {
  void* state;
  long long s_b, s_h;
  const void* x;
  long long x_b, x_h;
  const void* dt;
  long long dt_b, dt_h;
  const void* A;
  const void* Bm;
  long long b_b;
  const void* Cm;
  long long c_b;
  const unsigned char* mask;
  void* y;
  int B, H, P, N;
};

template <int ITERS, bool VEC, typename T>
cudaError_t launch_step(const Args& a, int warps, int lanes_log2,
                   cudaStream_t stream) {
  ssd_decode_kernel<ITERS, VEC, T><<<a.B * a.H, 32 * warps, 0, stream>>>(
      static_cast<float*>(a.state), a.s_b, a.s_h, static_cast<const T*>(a.x),
      a.x_b, a.x_h, static_cast<const float*>(a.dt), a.dt_b, a.dt_h,
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm), a.b_b,
      static_cast<const T*>(a.Cm), a.c_b, a.mask, static_cast<float*>(a.y),
      a.H, a.P, a.N, lanes_log2);
  return cudaGetLastError();
}

// The smallest instantiation that holds `iters` p rows a thread.
template <bool VEC, typename T>
cudaError_t launch_iters(const Args& a, int iters, int warps,
                         int lanes_log2, cudaStream_t st) {
  if (iters <= 1) return launch_step<1, VEC, T>(a, warps, lanes_log2, st);
  if (iters <= 2) return launch_step<2, VEC, T>(a, warps, lanes_log2, st);
  if (iters <= 4) return launch_step<4, VEC, T>(a, warps, lanes_log2, st);
  return launch_step<8, VEC, T>(a, warps, lanes_log2, st);
}

template <typename T>
cudaError_t launch_vec(const Args& a, bool vec, int iters, int warps,
                       int lanes_log2, cudaStream_t st) {
  return vec ? launch_iters<true, T>(a, iters, warps, lanes_log2, st)
             : launch_iters<false, T>(a, iters, warps, lanes_log2, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// One decode step of `state` in place, y out (layouts above, strides in
// elements). `x_bf16`: x, Bm and Cm are bf16 (else f32). `write` (n int32
// rows) or null for every row; `mask` is (B,) bytes of scratch, used only
// with `write`. Returns 0, a CUDA error code from a launch, or -1 for an
// unsupported shape or state dim.
int ssd_decode_launch(void* state, long long s_b, long long s_h,
                      const void* x, long long x_b, long long x_h, int x_bf16,
                      const void* dt, long long dt_b, long long dt_h,
                      const void* A, const void* Bm, long long b_b,
                      const void* Cm, long long c_b, const void* write,
                      int n_write, void* mask, void* y, int B, int H, int P,
                      int N, void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (write != nullptr && mask == nullptr))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = nullptr;
  if (write != nullptr) {
    ssd_decode_mask_kernel<<<1, kMaskThreads, 0, st>>>(
        static_cast<const int*>(write), n_write,
        static_cast<unsigned char*>(mask), B);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    m = static_cast<const unsigned char*>(mask);
  }
  int lanes_log2 = 0;
  while ((4 << lanes_log2) < N) ++lanes_log2;
  const int rows = 32 >> lanes_log2;
  const int need = (P + rows - 1) / rows;    // warps to cover P in one pass
  const int warps = need < kMaxWarps ? need : kMaxWarps;
  const int iters = (P + warps * rows - 1) / (warps * rows);
  const bool vec =
      N % 4 == 0 && aligned16(state) && s_b % 4 == 0 && s_h % 4 == 0;
  const Args a{state, s_b, s_h, x,   x_b, x_h, dt, dt_b, dt_h, A,
               Bm,    b_b, Cm,  c_b, m,   y,   B,  H,    P,    N};
  const cudaError_t e =
      x_bf16
          ? launch_vec<__nv_bfloat16>(a, vec, iters, warps, lanes_log2, st)
          : launch_vec<float>(a, vec, iters, warps, lanes_log2, st);
  return static_cast<int>(e);
}

const char* ssd_decode_error_string(int code) {
  return code < 0 ? "unsupported shape or state dim"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
