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
// rounded to w's dtype, products accumulate in float32 on the CUDA cores
// (FFMA, no TF32) and the result is rounded to x's dtype. The prologue uses
// __fmul_rn/__fadd_rn so that nvcc does not contract it into an FMA (h is
// then bit-identical to the plain PyTorch version, x.float() * a + b), and
// its ReLU is jnp.maximum(z, 0), which keeps a NaN (fmaxf would return 0).
//
// Design. The host (ops/fused_dense.py, `launch_plan`) picks per shape a
// BM x BN output tile and a K-split S <= 8: the largest tile whose grid fills
// the 132 SMs unsplit; failing that, the deepest split of K, with a small
// tile that reaches a wave of 132 CTAs where one does. The S CTAs that share an
// output tile form one thread-block cluster along K; rank r walks chunks
// [r*C/S, (r+1)*C/S) of the C = ceil(K/32) chunks of K. Each CTA keeps a ring
// of STAGES chunks of x, w, a and b in shared memory, filled with 16-byte
// cp.async (zero-filled past M, K and N), so the next chunks land while the
// current one's FFMAs run. When a chunk of x arrives, the BN + ReLU prologue is
// applied once per element and h is stored k-major beside it; every thread
// then accumulates a TM x TN register tile from h and w. At the end each CTA
// stores its partial tile in its own shared memory; after the cluster
// barrier, rank r sums a 1/S share of the tile over ranks 0..S-1 in that
// order, reading its peers through distributed shared memory, and writes the
// share out. One launch, no workspace, no atomics, and the same bits from run
// to run. Every row of x and w must be whole 16-byte pieces (K and N multiples
// of 4 in float32, of 8 in bfloat16) and every operand 16-byte aligned: the
// launcher refuses other shapes, and the wrapper raises on them first. Every
// DenseNet of the model registry has K a multiple of 32 and N = 128.
//
// What bounds it on an H100: at DenseNet121's shapes (K = 64..992, N = 128)
// it does 2*N = 256 flops per element of x it reads. In float32 (64 flops per
// byte, against the CUDA cores' 67 TFLOP/s over 3.35 TB/s = 20) the bound is
// the operations; in bfloat16 (against the tensor cores' 989 TFLOP/s) the
// bytes. Per dense block at batch 8: block 1 (M = 32768) and block 2
// (M = 4096) fill the card without a split and are bound by FFMA issue; in
// blocks 3 and 4 (M = 512 and 64) the byte and flop bounds are under a
// microsecond per call (0.8 us on average), and the true floor is a few
// microseconds for one launch whose CTAs wait on a first load, walk a chain
// of dependent chunks and meet at the cluster barriers (at M = 64 on an
// H100, 6.6 us at Cin 256 and 9.5 us at Cin 992 with the fastest plan): the
// split along K is what shortens that chain. bf16 also runs on the CUDA cores; its
// tensor-core product waits for a served bf16 path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;         // depth of one chunk of K; K-slices are whole chunks
constexpr int MAX_SPLIT = 8;   // the portable cluster size

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

// relu(x * a + b) as jnp.maximum(z, 0.0): a NaN z stays NaN
__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  const float z = __fadd_rn(__fmul_rn(x, a), b);
  return (z > 0.f || z != z) ? z : 0.f;
}

// bfloat16 is the top half of a float32: widening is a shift
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// four consecutive values in shared memory, as float
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// the 16 bytes of one copy, as floats
__device__ __forceinline__ void unpack(uint4 r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float (&f)[8]) {
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(u[i]);
    f[2 * i + 1] = bf16_hi(u[i]);
  }
}

// 16-byte asynchronous copy; src_bytes 0 writes zeros (a masked edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of one tile shape.
template <typename T, int BM, int BN, int TM, int TN, int STAGES>
struct Tile {
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int COLS = BN / TN;          // threads across a row of the tile
  static constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte copy
  // x rows padded by 16 bytes: the prologue's 16-byte reads down a column of
  // rows then fall in distinct banks
  static constexpr int XS = BK + VEC;
  static constexpr int HS = BM + 4;             // h is k-major: [BK][HS] floats
  static constexpr int X_STAGE = BM * XS;       // elements of T
  static constexpr int W_STAGE = BK * BN;
  static constexpr int AB_STAGE = 2 * BK;      // floats: a then b of the chunk
  static constexpr int RING_BYTES =
      STAGES * ((X_STAGE + W_STAGE) * (int)sizeof(T) + AB_STAGE * (int)sizeof(float));
  static constexpr int PART_BYTES = BM * BN * (int)sizeof(float);
  // the partial tile reuses the ring once the K loop is done
  static constexpr int UNION_BYTES = RING_BYTES > PART_BYTES ? RING_BYTES : PART_BYTES;
  static constexpr int SMEM_BYTES = UNION_BYTES + BK * HS * (int)sizeof(float);
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are read as float4");
  static_assert(COLS >= 8, "a quarter warp must share one row band of h");
};

template <typename T, int BM, int BN, int TM, int TN, int STAGES>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fused_bn_relu_matmul_kernel(const T* __restrict__ x, const float* __restrict__ a,
                            const float* __restrict__ b, const T* __restrict__ w,
                            T* __restrict__ out, int M, int K, int N, int split) {
  using L = Tile<T, BM, BN, TM, TN, STAGES>;
  constexpr int THREADS = L::THREADS, COLS = L::COLS, VEC = L::VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);              // [STAGES][BM][XS]
  T* ws = xs + STAGES * L::X_STAGE;                // [STAGES][BK][BN]
  float* ab = reinterpret_cast<float*>(ws + STAGES * L::W_STAGE);  // [STAGES][2][BK]
  float* part = reinterpret_cast<float*>(smem);    // [BM][BN], after the K loop
  float* hs = reinterpret_cast<float*>(smem + L::UNION_BYTES);  // [BK][HS]

  const int tid = threadIdx.x;
  // the cluster is (split, 1, 1), so this is the CTA's rank in it
  const int rank = blockIdx.x % split;
  const int row0 = (blockIdx.x / split) * BM;
  const int col0 = blockIdx.y * BN;
  const int chunks = (K + BK - 1) / BK;
  const int c_begin = rank * chunks / split;
  const int n_chunks = (rank + 1) * chunks / split - c_begin;

  auto load_chunk = [&](int c, int stage) {
    const int k0 = c * BK;
    T* xd = xs + stage * L::X_STAGE;
    T* wd = ws + stage * L::W_STAGE;
    float* abd = ab + stage * L::AB_STAGE;
    // K and N are whole 16-byte pieces, so a piece is all inside or all out
    for (int i = tid; i < BM * (BK / VEC); i += THREADS) {
      const int r = i / (BK / VEC), kv = i % (BK / VEC) * VEC;
      const bool ok = row0 + r < M && k0 + kv < K;
      cp_async16(xd + r * L::XS + kv, ok ? x + (size_t)(row0 + r) * K + k0 + kv : x, ok);
    }
    for (int i = tid; i < BK * (BN / VEC); i += THREADS) {
      const int r = i / (BN / VEC), nv = i % (BN / VEC) * VEC;
      const bool ok = k0 + r < K && col0 + nv < N;
      cp_async16(wd + r * BN + nv, ok ? w + (size_t)(k0 + r) * N + col0 + nv : w, ok);
    }
    for (int i = tid; i < L::AB_STAGE / 4; i += THREADS) {
      const float* src = i < BK / 4 ? a : b;
      const int kv = i % (BK / 4) * 4;
      const bool ok = k0 + kv < K;
      cp_async16(abd + 4 * i, ok ? src + k0 + kv : src, ok);
    }
  };

  // fill the ring: one commit group per chunk, empty ones past the slice's
  // end, so that "chunk i has landed" is always wait_group(STAGES - 2)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(c_begin + s, s);
    cp_async_commit();
  }

  const int tr = tid / COLS;  // rows tr*TM .. tr*TM+TM-1 of the tile
  const int tc = tid % COLS;  // columns q*COLS*4 + tc*4 + 0..3, q < TN/4
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk i are in
    __syncthreads();              // everyone's are; chunk i-1's stage is free
    if (i + STAGES - 1 < n_chunks)
      load_chunk(c_begin + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    // prologue, once per element of the chunk: h = bn_relu(x), rounded to
    // w's dtype, stored k-major. Neighbouring threads take neighbouring rows.
    // Past K, x, a and b are zero-filled, so h is 0 there.
    const int stage = i % STAGES;
    const T* xc = xs + stage * L::X_STAGE;
    const float* abc = ab + stage * L::AB_STAGE;
    for (int j = tid; j < BM * (BK / VEC); j += THREADS) {
      const int r = j % BM, kv = j / BM * VEC;
      float v[VEC];
      unpack(*reinterpret_cast<const uint4*>(xc + r * L::XS + kv), v);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        hs[(kv + e) * L::HS + r] =
            to_float(from_float<T>(bn_relu(v[e], abc[kv + e], abc[BK + kv + e])));
    }
    __syncthreads();

    const T* wc = ws + stage * L::W_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int p = 0; p < TM; p += 4) {
        const float4 t = load4(hs + kk * L::HS + tr * TM + p);
        av[p] = t.x;
        av[p + 1] = t.y;
        av[p + 2] = t.z;
        av[p + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 t = load4(wc + kk * BN + q * COLS * 4 + tc * 4);
        bv[4 * q] = t.x;
        bv[4 * q + 1] = t.y;
        bv[4 * q + 2] = t.z;
        bv[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int p = 0; p < TM; ++p)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[p][j] = fmaf(av[p], bv[j], acc[p][j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial tile now
#pragma unroll
  for (int p = 0; p < TM; ++p)
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      *reinterpret_cast<float4*>(part + (tr * TM + p) * BN + q * COLS * 4 + tc * 4) =
          make_float4(acc[p][4 * q], acc[p][4 * q + 1], acc[p][4 * q + 2], acc[p][4 * q + 3]);

  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();  // every rank's partial tile is in its shared memory
  else
    __syncthreads();

  // this rank's share of the tile, in groups of 4 columns, summed over the
  // ranks 0..split-1 in that order
  constexpr int GROUPS = BM * BN / 4;
  const int g_end = (rank + 1) * GROUPS / split;
  for (int g = rank * GROUPS / split + tid; g < g_end; g += THREADS) {
    // all reads in flight first, then the sum in rank order
    float4 t[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split) t[q] = load4((split > 1 ? cluster.map_shared_rank(part, q) : part) + 4 * g);
    float4 s = t[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) {
        s.x += t[q].x;
        s.y += t[q].y;
        s.z += t[q].z;
        s.w += t[q].w;
      }
    const int gr = row0 + 4 * g / BN, gc = col0 + 4 * g % BN;
    if (gr >= M) continue;
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gc + j < N) out[(size_t)gr * N + gc + j] = from_float<T>(v[j]);
  }
  if (split > 1) cluster.sync();  // peers may still read this CTA's tile
}

template <typename T, int BM, int BN, int TM, int TN, int STAGES>
cudaError_t launch(const void* x, const float* a, const float* b, const void* w,
                   void* out, int M, int K, int N, int split, cudaStream_t stream) {
  using L = Tile<T, BM, BN, TM, TN, STAGES>;
  auto kernel = fused_bn_relu_matmul_kernel<T, BM, BN, TM, TN, STAGES>;
  if (L::SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  const long long tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  if (tiles_m * split >= (1LL << 31) || tiles_n > 65535) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  if (K % L::VEC || N % L::VEC || ptrs % 16) return cudaErrorInvalidValue;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles_m * split), (unsigned)tiles_n, 1);
  cfg.blockDim = dim3(L::THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), a, b,
                            static_cast<const T*>(w), static_cast<T*>(out), M, K,
                            N, split);
}

template <typename T>
cudaError_t dispatch(int bm, int bn, const void* x, const float* a, const float* b,
                     const void* w, void* out, int M, int K, int N, int split,
                     cudaStream_t s) {
  // the tiles of ops/fused_dense.py's TILES: (BM, BN, TM, TN, STAGES)
  if (bm == 128 && bn == 128) return launch<T, 128, 128, 8, 8, 2>(x, a, b, w, out, M, K, N, split, s);
  if (bm == 64 && bn == 128) return launch<T, 64, 128, 8, 8, 3>(x, a, b, w, out, M, K, N, split, s);
  if (bm == 64 && bn == 64) return launch<T, 64, 64, 4, 8, 3>(x, a, b, w, out, M, K, N, split, s);
  if (bm == 32 && bn == 64) return launch<T, 32, 64, 4, 4, 3>(x, a, b, w, out, M, K, N, split, s);
  if (bm == 32 && bn == 32) return launch<T, 32, 32, 4, 4, 3>(x, a, b, w, out, M, K, N, split, s);
  if (bm == 16 && bn == 32) return launch<T, 16, 32, 4, 4, 3>(x, a, b, w, out, M, K, N, split, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (bm, bn, split_k) is the host's launch
// plan: the output tile and the number of CTAs in a cluster that split K.
// Launches on `stream` (PyTorch's current stream) on device `device`;
// returns the cudaError_t of the launch.
extern "C" int fused_bn_relu_matmul_launch(int dtype, const void* x,
                                           const float* a, const float* b,
                                           const void* w, void* out, int M,
                                           int K, int N, int bm, int bn,
                                           int split_k, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (split_k < 1 || split_k > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(bm, bn, x, a, b, w, out, M, K, N, split_k, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(bm, bn, x, a, b, w, out, M, K, N, split_k, s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
