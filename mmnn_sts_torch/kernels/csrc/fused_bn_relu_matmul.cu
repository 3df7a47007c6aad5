// Fused eval BatchNorm + ReLU + 1x1x1 convolution: out = relu(x * a + b) @ w.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/fused_dense.py
// (`_kernel` / `_forward`, reached through `fused_bn_relu_matmul` and
// `bn_relu_conv1x1`): the bottleneck of every DenseNet dense layer, 58 calls
// per DenseNet121 forward.
//
//   x   (M, K) row-major, float32 or bfloat16   (channels-last activations)
//   a,b (K,)   float32                           (folded BN affine)
//   w   (K, N) row-major, same dtype as x        (1x1x1 conv kernel)
//   out (M, N) row-major, dtype of x
//
// Numerics follow fused_dense.py:45-50: the prologue runs in float32, h is
// rounded to w's dtype, products accumulate in float32 and the result is
// rounded to x's dtype. The prologue uses __fmul_rn/__fadd_rn so that nvcc
// does not contract it into an FMA: h is then bit-identical to the plain
// PyTorch version (x.float() * a + b).
//
// What bounds it on an H100: at DenseNet121's shapes (K = 64..992, N = 128)
// it does 2*N = 256 flops per element of x it reads. In float32 (64 flops
// per byte, against the CUDA cores' 67 TFLOP/s over 3.35 TB/s = 20) it is
// bound by operations; in bfloat16 (128 flops per byte, against the tensor
// cores' 989 TFLOP/s over 3.35 TB/s = 295) by bytes. This first version
// runs both types on the CUDA cores, so in bfloat16 it is far from its
// bound; the tensor cores (wgmma) are later work. Design: one block computes a
// BM x BN tile of out and walks K in BK-wide chunks. Each chunk of x is read
// once from device memory, normalised + ReLU'd on the load and stored
// transposed in shared memory; the matching chunk of w goes beside it; each
// thread then accumulates a TM x TN register tile in float32. So h never
// goes back to device memory (the point of the TPU kernel too). Rows past M,
// columns past K and N are masked. wgmma, TMA and tuning are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int COL_THREADS = BN / TN;            // 32: one warp spans a row band

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_bn_relu_matmul_kernel(const T* __restrict__ x, const float* __restrict__ a,
                            const float* __restrict__ b, const T* __restrict__ w,
                            T* __restrict__ out, int M, int K, int N) {
  // h chunk stored transposed (k-major) so the inner loop reads one row of
  // it per k; +1 pads away bank conflicts on the transposing store.
  __shared__ float hs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tr = tid / COL_THREADS;  // warp index: rows tr*TM .. tr*TM+TM-1
  const int tc = tid % COL_THREADS;  // columns tc, tc+32, tc+64, tc+96

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x chunk (BM x BK): neighbouring threads read neighbouring k of a row.
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gk = k0 + c;
      float h = 0.f;
      if (gr < M && gk < K) {
        const float v = to_float(x[(size_t)gr * K + gk]);
        h = fmaxf(__fadd_rn(__fmul_rn(v, a[gk]), b[gk]), 0.f);
        h = to_float(from_float<T>(h));  // h.astype(w.dtype)
      }
      hs[c][r] = h;
    }
    // w chunk (BK x BN): neighbouring threads read neighbouring columns.
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = col0 + c;
      ws[r][c] = (gk < K && gn < N) ? to_float(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = hs[kk][tr * TM + i];  // broadcast
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tc + j * COL_THREADS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr * TM + i;
    if (gr >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tc + j * COL_THREADS;
      if (gn < N) out[(size_t)gr * N + gn] = from_float<T>(acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` (PyTorch's current
// stream) on device `device`; returns the cudaError_t of the launch.
extern "C" int fused_bn_relu_matmul_launch(int dtype, const void* x,
                                           const float* a, const float* b,
                                           const void* w, void* out, int M,
                                           int K, int N, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fused_bn_relu_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), a, b, static_cast<const float*>(w),
        static_cast<float*>(out), M, K, N);
  } else if (dtype == 1) {
    fused_bn_relu_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), a, b,
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
