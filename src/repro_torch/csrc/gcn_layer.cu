// One GCN layer for Hopper (sm_90a): out = relu?(A_hat . X . W + b), f32.
//
// Replaces the Pallas TPU kernel `_gcn_kernel` / `gcn_layer` in
// src/repro/kernels/gcn_fused.py, the paper's Eq. 6 on the cluster graph.
// The balancer's actor runs two of these on every control tick.
//
// Shapes: A_hat (N, N), X (Bt, N, F), W (F, H), b (H,), out (Bt, N, H), all
// contiguous f32. The serve path passes Bt = 1 (X is (N, F)); the batched
// form serves a batch of observations.
//
// Bound: neither bytes nor operations. The control plane's graphs are tiny
// (N = 2 at the serve defaults, 16 in the paper's cluster): the inputs are a
// few KB and the work a few hundred thousand FMAs, nanoseconds at 3.35 TB/s
// or 67 TFLOP/s f32. What bounds a call in practice is the launch itself
// (a few microseconds). So the design aims at one launch per layer with
// the intermediate kept on chip, which is what the TPU kernel did in VMEM:
//
//   * one block per (tile of kTM output rows, batch element);
//   * the block computes its kTM x F rows of A_hat . X into shared memory,
//     streaming X through shared memory kKM rows at a time together with
//     the matching kTM x kKM tile of A_hat;
//   * it then multiplies those rows by W (read through the read-only cache),
//     adds b, applies the relu and writes out. A_hat . X never reaches HBM.
//
// Plain f32 FMA throughout: at these sizes tensor cores would not move the
// launch-bound time. Ragged row tiles (N % kTM) and ragged X chunks are
// masked. Shared memory is (kTM + kKM) * F + kTM * kKM floats; above 48 KB
// (F > 376) it is requested through the max-dynamic-shared-memory function
// attribute, up to the card's 227 KB (F <= 1,808).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 16;  // output rows per block
constexpr int kKM = 16;  // rows of X (columns of A_hat) staged per step
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit

__global__ void __launch_bounds__(kThreads)
gcn_layer_kernel(const float* __restrict__ a, const float* __restrict__ x,
                 const float* __restrict__ w, const float* __restrict__ b,
                 float* __restrict__ out, int n, int f, int h, int relu) {
  extern __shared__ float smem[];
  float* ax = smem;            // kTM x f: this tile's rows of A_hat . X
  float* xs = ax + kTM * f;    // kKM x f: the staged rows of X
  float* as = xs + kKM * f;    // kTM x kKM: the matching tile of A_hat
  const int row0 = blockIdx.x * kTM;
  const int rows = min(kTM, n - row0);
  const float* xb = x + static_cast<long long>(blockIdx.y) * n * f;
  const int tid = threadIdx.x;

  // every (row, feature) of the tile is owned by one thread for the whole
  // sum, through the same strided mapping in each pass below
  for (int i = tid; i < rows * f; i += kThreads) ax[i] = 0.f;
  for (int m0 = 0; m0 < n; m0 += kKM) {
    const int km = min(kKM, n - m0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < km * f; i += kThreads)
      xs[i] = xb[static_cast<long long>(m0) * f + i];
    for (int i = tid; i < kTM * kKM; i += kThreads) {
      const int r = i / kKM, c = i % kKM;
      as[i] = (r < rows && c < km)
                  ? a[static_cast<long long>(row0 + r) * n + m0 + c]
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

  float* ob = out + (static_cast<long long>(blockIdx.y) * n + row0) * h;
  for (int i = tid; i < rows * h; i += kThreads) {
    const int r = i / h, c = i % h;
    const float* axr = ax + r * f;
    float s = 0.f;
    for (int k = 0; k < f; ++k)
      s = fmaf(axr[k], __ldg(w + static_cast<long long>(k) * h + c), s);
    s += __ldg(b + c);
    ob[i] = relu ? fmaxf(s, 0.f) : s;
  }
}

size_t smem_bytes(int f) {
  return (static_cast<size_t>(kTM + kKM) * f + kTM * kKM) * sizeof(float);
}

}  // namespace

extern "C" {

// a (n, n), x (batch, n, f), w (f, h), b (h,), out (batch, n, h): contiguous
// f32 device pointers. Returns 0, a CUDA error code from the attribute call
// or the launch, or -1 for unsupported sizes (a zero dimension, or F too
// wide for one block's shared memory).
int gcn_layer_launch(const void* a, const void* x, const void* w,
                     const void* b, void* out, int batch, int n, int f, int h,
                     int relu, void* stream) {
  if (batch < 1 || n < 1 || f < 1 || h < 1) return -1;
  const size_t smem = smem_bytes(f);
  if (smem > kMaxSmem) return -1;
  static size_t attr_set = kDefaultSmem;
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gcn_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = kMaxSmem;
  }
  const dim3 grid((n + kTM - 1) / kTM, batch);
  gcn_layer_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), n, f, h, relu);
  return static_cast<int>(cudaGetLastError());
}

const char* gcn_layer_error_string(int code) {
  return code < 0 ? "unsupported sizes (a zero dimension, or F above the "
                    "shared-memory limit)"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
