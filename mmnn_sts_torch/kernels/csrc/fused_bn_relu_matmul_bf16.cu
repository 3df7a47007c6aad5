// Fused BatchNorm + ReLU + 1x1x1 convolution in bfloat16, on Hopper's tensor
// cores: out = relu(x * a + b) @ w.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/fused_dense.py:58
// (`_kernel` / `_forward`, reached through `fused_bn_relu_matmul` and
// `bn_relu_conv1x1`) for bfloat16 operands: the bottleneck of every DenseNet
// dense layer, 58 calls per DenseNet121 forward. float32 operands take
// fused_bn_relu_matmul.cu.
//
//   x   (M, K) row-major bfloat16   (channels-last activations)
//   a,b (K,)   float32              (folded BN affine)
//   w   (K, N) row-major bfloat16   (1x1x1 conv kernel)
//   out (M, N) row-major bfloat16
//
// Numerics follow fused_dense.py:45-50 and the plain PyTorch version: the
// prologue runs in float32 as __fmul_rn then __fadd_rn (no FMA contraction,
// so h is bit-identical to x.float() * a + b), its ReLU keeps a NaN
// (jnp.maximum, not fmaxf), h is rounded to bfloat16 (RN), the bf16 x bf16
// products accumulate in float32 on the tensor cores and the sum is rounded
// to bfloat16 once.
//
// What bounds it on an H100: at DenseNet's shapes (N = 128) the op does
// 2 * N = 256 flops per element of x, 128 flops per byte read, below the
// ~295 flops a byte at which the tensor cores (989 TFLOP/s) overtake HBM
// (3.35 TB/s): the bytes bound it, and at small M the latency of one
// launch (the first load, the chain of chunks a CTA walks, the cluster's
// barriers).
//
// Design. One warpgroup (128 threads) per 64 rows of the BM x BN output
// tile (BM 64 or 128, BN 64 or 128; ops/fused_dense.py's
// `bf16_launch_plan` picks the tile and the K-split per shape). K is walked in 64-deep chunks
// (128 bytes of bf16 a row) through a ring of STAGES stages in shared
// memory, each filled by TMA (cp.async.bulk.tensor) and completing on its
// own mbarrier: x as a BM x 64 box and w as 64 x 64 panels, both in the
// 128-byte swizzle, and the chunk's 64 values of a and b. The host encodes
// the four tensor maps per call (libcuda's cuTensorMapEncodeTiled, found
// through the CUDA runtime) and passes them as __grid_constant__
// parameters. Out of bounds (past M, K or N) TMA fills zeros: x, a and b
// past K give h = 0 and w's rows past K are 0, so any K that is a multiple
// of 8 works. For each 16-deep step of a chunk every warp reads its 16 x 16
// piece of x with ldmatrix straight into the wgmma A-fragment layout,
// applies the prologue per element in registers (a and b from shared
// memory), packs h to bf16x2 and issues wgmma.mma_async m64n64k16 with A
// from those registers and B = w's panel from shared memory (w is N-major,
// so the transposed-B form): h never touches shared memory. After a chunk
// the warpgroups wait for their products, meet at a barrier and thread 0
// refills the stage with the chunk STAGES ahead.
//
// Small M: the S CTAs that share an output tile form one thread-block
// cluster along K; rank r walks chunks [r*C/S, (r+1)*C/S) of the
// C = ceil(K/64) chunks. Rank r owns a 1/S share of the output tile: every
// CTA pushes its float32 partial of each share into a slot of the owner's
// shared memory through distributed shared memory, and after one cluster
// barrier rank r sums its slots in rank order 0..S-1, rounds the sum to
// bf16 and writes it with 16-byte stores (masked past M and N). One launch,
// no workspace, no atomics, and the same bits from run to run. An unsplit
// launch (SPLIT false) is a plain grid that stages its tile in the ring.
// The launcher refuses K or N that are not multiples of 8 and operands off
// 16-byte boundaries (TMA's rules; the wrapper raises on them first).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;          // depth of one chunk of K: 128 bytes of bf16
constexpr int MAX_SPLIT = 8;    // the portable cluster size
constexpr int PANEL = 64;       // columns of one swizzled panel of w (128 bytes)
constexpr int PANEL_BYTES = BK * PANEL * 2;

// relu(x * a + b) as jnp.maximum(z, 0.0): a NaN z stays NaN
__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  const float z = __fadd_rn(__fmul_rn(x, a), b);
  return (z > 0.f || z != z) ? z : 0.f;
}

// two floats rounded (RN) to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two bf16 of x (low half first) -> two bf16 of h, packed as wgmma takes them
__device__ __forceinline__ uint32_t prologue2(uint32_t xv, float2 a, float2 b) {
  const float x0 = __uint_as_float(xv << 16), x1 = __uint_as_float(xv & 0xffff0000u);
  return pack_bf16x2(bn_relu(x0, a.x, b.x), bn_relu(x1, a.y, b.y));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits for the phase of `bar` with this parity; a copy that never lands
// (some 10 s of clocks) traps, so a fault fails the launch instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (!start)
      start = clock64();
    else if (clock64() - start > (1LL << 34))
      __trap();
  }
}

// starts fetching a tensor map's descriptor before its first copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA: one box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map, int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the four 8 x 8 pieces of a 16 x 16 bf16 tile: {rows 0-7, 8-15} x {k 0-7, 8-15}
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// wgmma shared-memory descriptor of one 16 (k) x 64 (n) piece of a w panel:
// N-major, 128-byte swizzle, k rows 128 bytes apart, so 8-row groups 1024
// bytes apart. A 64-wide panel is one swizzle atom across N, so the leading
// offset is not used; it is set to the same 1024.
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the two halves of a cluster barrier: arrive without waiting, and wait
// for every CTA's arrival
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64, float32, accumulated) += h (64 x 16, bf16, registers) x
// w (16 x 64, bf16, shared memory, N-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&h)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]), "l"(desc), "r"(1));
}

// a group of 8 sums of the output tile, rounded to bf16, as one 16-byte
// store; none past M or N (N is a multiple of 8: a group is all in or out)
__device__ __forceinline__ void store_group(__nv_bfloat16* out, int row, int col, int M, int N,
                                            float4 lo, float4 hi) {
  if (row < M && col < N)
    *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
        make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w), pack_bf16x2(hi.x, hi.y),
                   pack_bf16x2(hi.z, hi.w));
}

// keeps the compiler from moving reads of d across a wgmma wait
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory layout of one tile shape (bytes, from a 1024-aligned base).
template <int BM, int BN, int STAGES>
struct Tile {
  static constexpr int THREADS = BM / 64 * 128;    // one warpgroup per 64 rows
  static constexpr int PANELS = BN / PANEL;
  static constexpr int X_BYTES = BM * BK * 2;      // one chunk of x, swizzled
  static constexpr int W_BYTES = PANELS * PANEL_BYTES;
  static constexpr int AB_BYTES = 2 * BK * 4;      // a then b of the chunk
  static constexpr int RING_BYTES = STAGES * (X_BYTES + W_BYTES);
  static constexpr int PS = BN + 8;                // row stride of the partial tile (floats)
  static constexpr int PART_BYTES = BM * PS * 4;
  static constexpr int AB_OFFSET = RING_BYTES;
  static constexpr int BAR_OFFSET = AB_OFFSET + STAGES * AB_BYTES;
  static constexpr int SLOT_OFFSET = BAR_OFFSET + 128;  // split only: the owners' slots
  static constexpr int SLOT_BYTES = (BM * BN / 8 + MAX_SPLIT) * 32;
  static constexpr int SMEM_BYTES = 1024 + SLOT_OFFSET;  // + alignment slack
  static constexpr int SPLIT_SMEM_BYTES = SMEM_BYTES + SLOT_BYTES;
  static constexpr uint32_t TX_BYTES = X_BYTES + W_BYTES + AB_BYTES;
  static_assert(PART_BYTES <= RING_BYTES, "the partial tile reuses the ring");
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "swizzled tiles stay 1024-aligned");
  static_assert(STAGES * 8 <= 128, "the barriers fit below the slots");
};

template <int BM, int BN, int STAGES, bool SPLIT>
__global__ void __launch_bounds__(BM / 64 * 128)
fused_bn_relu_matmul_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                                 const __grid_constant__ CUtensorMap map_w,
                                 const __grid_constant__ CUtensorMap map_a,
                                 const __grid_constant__ CUtensorMap map_b,
                                 __nv_bfloat16* __restrict__ out, int M, int K, int N,
                                 int split) {
  using L = Tile<BM, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 128-byte swizzle: 1024-aligned
  const uint32_t base = smem_u32(smem);
  const uint32_t xs = base;                               // [STAGES][X_BYTES]
  const uint32_t ws = base + STAGES * L::X_BYTES;         // [STAGES][PANELS][PANEL_BYTES]
  const float* ab = reinterpret_cast<const float*>(smem + L::AB_OFFSET);  // [STAGES][2][BK]
  const uint32_t bars = base + L::BAR_OFFSET;             // [STAGES] uint64
  float* part = reinterpret_cast<float*>(smem);           // [BM][PS], after the K loop

  if constexpr (!SPLIT) split = 1;  // lets the compiler fold the rank's arithmetic
  const int tid = threadIdx.x;
  const int warp = tid / 32 % 4, lane = tid % 32;
  const int wg_row = tid / 128 * 64;  // this warpgroup's 64 rows of the tile
  // the cluster is (split, 1, 1), so this is the CTA's rank in it
  const int rank = blockIdx.x % split;
  const int row0 = (blockIdx.x / split) * BM;
  const int col0 = blockIdx.y * BN;
  const int chunks = (K + BK - 1) / BK;
  const int c_begin = rank * chunks / split;
  const int n_chunks = (rank + 1) * chunks / split - c_begin;

  // thread 0 fills a stage with chunk c: x, w's panels, a and b
  auto load_chunk = [&](int c, int s) {
    const int k0 = c * BK;
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, L::TX_BYTES);
    tma_2d(xs + s * L::X_BYTES, &map_x, k0, row0, bar);
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p)
      tma_2d(ws + s * L::W_BYTES + p * PANEL_BYTES, &map_w, col0 + p * PANEL, k0, bar);
    const uint32_t abd = base + L::AB_OFFSET + s * L::AB_BYTES;
    tma_1d(abd, &map_a, k0, bar);
    tma_1d(abd + BK * 4, &map_b, k0, bar);
  };
  if constexpr (SPLIT) cluster_arrive();  // this CTA has started; see the epilogue
  // thread 0 readies the barriers and starts the first loads at once; the
  // others meet it at the block barrier before they wait on a stage
  if (tid == 0) {
    prefetch_map(&map_x);
    prefetch_map(&map_w);
    prefetch_map(&map_a);
    prefetch_map(&map_b);
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < n_chunks; ++s) load_chunk(c_begin + s, s);
  }
  __syncthreads();

  float acc[L::PANELS][32];
#pragma unroll
  for (int p = 0; p < L::PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  // ldmatrix: lanes 0-7 address rows 0-7 (k 0-7) of the warp's 16 x 16
  // piece, 8-15 rows 8-15, 16-23 rows 0-7 at k 8-15, 24-31 rows 8-15 there
  const int lrow = wg_row + warp * 16 + (lane & 7) + (lane >> 3 & 1) * 8;
  const int lhalf = lane >> 4;
  const int t2 = lane % 4 * 2;  // the k columns (and +8) of this thread's h

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(bars + 8 * s, (i / STAGES) & 1);
    const uint32_t xrow = xs + s * L::X_BYTES + lrow * 128;
    const float* as = ab + s * 2 * BK;
    const float* bs = as + BK;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t xv[4], h[4];
      // 16-byte piece (2j + half) of the row, where the 128-byte swizzle put it
      ldmatrix_x4(xrow + (((2 * j + lhalf) ^ (lrow & 7)) << 4), xv);
      const int k = 16 * j + t2;
      const float2 a_lo = *reinterpret_cast<const float2*>(as + k);
      const float2 a_hi = *reinterpret_cast<const float2*>(as + k + 8);
      const float2 b_lo = *reinterpret_cast<const float2*>(bs + k);
      const float2 b_hi = *reinterpret_cast<const float2*>(bs + k + 8);
      h[0] = prologue2(xv[0], a_lo, b_lo);  // rows g, k .. k+1
      h[1] = prologue2(xv[1], a_lo, b_lo);  // rows g+8
      h[2] = prologue2(xv[2], a_hi, b_hi);  // rows g, k+8 .. k+9
      h[3] = prologue2(xv[3], a_hi, b_hi);  // rows g+8, k+8 ..
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        wgmma_m64n64k16(acc[p], h,
                        panel_desc(ws + s * L::W_BYTES + p * PANEL_BYTES + j * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p) fence_operands(acc[p]);
    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && i + STAGES < n_chunks) load_chunk(c_begin + i + STAGES, s);
  }

  // the output tile in groups of 8 columns: group g is row g / (BN/8),
  // columns g % (BN/8) * 8 ..+7. Accumulator layout of m64nNk16: d[4q + e]
  // is row 16*warp + lane/4 (+8 for e >= 2), column 8q + 2*(lane%4) + (e & 1).
  constexpr int GROUPS = BM * BN / 8;
  const int r = wg_row + warp * 16 + lane / 4;
  if constexpr (!SPLIT) {
    // the tile, float32, to the ring (rows padded against bank conflicts),
    // then rounded to bf16 and written out a group a thread
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(part + (r + 4 * e) * L::PS + p * PANEL + 8 * q + t2) =
              make_float2(acc[p][4 * q + e], acc[p][4 * q + e + 1]);
    __syncthreads();
    for (int g = tid; g < GROUPS; g += L::THREADS) {
      const int row = g / (BN / 8), c = g % (BN / 8) * 8;
      const float* src = part + row * L::PS + c;
      store_group(out, row0 + row, col0 + c, M, N, *reinterpret_cast<const float4*>(src),
                  *reinterpret_cast<const float4*>(src + 4));
    }
  } else {
    // Rank r owns groups [r*G/S, (r+1)*G/S) of the G. Every rank pushes
    // its partial of each group into slot `rank` of the owner's slot area,
    // which lies beside the ring (a slower peer may still be reading its
    // ring), through distributed shared memory: stores that need no answer,
    // so one cluster barrier orders them all. Then each rank sums its
    // groups over the slots 0..split-1 in that order.
    const int share = (GROUPS + split - 1) / split;  // groups in a slot
    float* slots = reinterpret_cast<float*>(smem + L::SLOT_OFFSET);  // [split][share][8]
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();  // every peer has started (arrived at the top)
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int g = (r + 4 * e) * (BN / 8) + p * (PANEL / 8) + q;
          const int owner = ((g + 1) * split - 1) / GROUPS;
          float* dst = cluster.map_shared_rank(slots, owner) +
                       (rank * share + g - owner * GROUPS / split) * 8 + t2;
          *reinterpret_cast<float2*>(dst) = make_float2(acc[p][4 * q + e], acc[p][4 * q + e + 1]);
        }
    cluster.sync();  // every rank's groups are in their owners' slots
    const int g0 = rank * GROUPS / split;
    for (int g = g0 + tid; g < (rank + 1) * GROUPS / split; g += L::THREADS) {
      const float* src = slots + (g - g0) * 8;
      float4 s0 = *reinterpret_cast<const float4*>(src);
      float4 s1 = *reinterpret_cast<const float4*>(src + 4);
      for (int q = 1; q < split; ++q) {
        const float4 t0 = *reinterpret_cast<const float4*>(src + q * share * 8);
        const float4 t1 = *reinterpret_cast<const float4*>(src + q * share * 8 + 4);
        s0.x += t0.x; s0.y += t0.y; s0.z += t0.z; s0.w += t0.w;
        s1.x += t1.x; s1.y += t1.y; s1.z += t1.z; s1.w += t1.w;
      }
      store_group(out, row0 + g / (BN / 8), col0 + g % (BN / 8) * 8, M, N, s0, s1);
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime: the
// library links only the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows, cols) tensor as boxes of (box_rows, box_cols), or a
// vector (rows = 0) as boxes of box_cols; zeros out of bounds
bool encode(CUtensorMap* map, EncodeTiled fn, CUtensorMapDataType type, int elem_bytes,
            const void* ptr, long long rows, long long cols, int box_rows, int box_cols,
            CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, rows ? 2 : 1, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one instantiation's launch: a cluster of `split` CTAs along K with the
// owners' slots (SPLIT), or a plain grid
template <int BM, int BN, int STAGES, bool SPLIT>
cudaError_t launch_kernel(const CUtensorMap& map_x, const CUtensorMap& map_w,
                          const CUtensorMap& map_a, const CUtensorMap& map_b, void* out, int M,
                          int K, int N, int split, dim3 grid, int device, cudaStream_t stream) {
  using L = Tile<BM, BN, STAGES>;
  constexpr int smem_bytes = SPLIT ? L::SPLIT_SMEM_BYTES : L::SMEM_BYTES;
  auto kernel = fused_bn_relu_matmul_bf16_kernel<BM, BN, STAGES, SPLIT>;
  // the shared-memory limit is set once a device (a bit each, 64 devices)
  static unsigned long long smem_set = 0;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!(smem_set >> device & 1)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    smem_set |= 1ULL << device;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(L::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, map_a, map_b,
                            static_cast<__nv_bfloat16*>(out), M, K, N, split);
}

template <int BM, int BN, int STAGES>
cudaError_t launch(const void* x, const float* a, const float* b, const void* w, void* out,
                   int M, int K, int N, int split, int device, cudaStream_t stream) {
  const long long tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  if (tiles_m * split >= (1LL << 31) || tiles_n > 65535) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  if (K % 8 || N % 8 || ptrs % 16) return cudaErrorInvalidValue;

  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  CUtensorMap map_x, map_w, map_a, map_b;
  if (!encode(&map_x, fn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM, BK,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_w, fn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K, N, BK, PANEL,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_a, fn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, 0, K, 1, BK,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&map_b, fn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, 0, K, 1, BK,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles_m * split), (unsigned)tiles_n, 1);
  return split > 1 ? launch_kernel<BM, BN, STAGES, true>(map_x, map_w, map_a, map_b, out, M, K,
                                                         N, split, grid, device, stream)
                   : launch_kernel<BM, BN, STAGES, false>(map_x, map_w, map_a, map_b, out, M, K,
                                                          N, split, grid, device, stream);
}

}  // namespace

// (bm, bn, split_k) is the host's launch plan: the output tile (one of
// ops/fused_dense.py's BF16_TILES) and the number of CTAs in a cluster that
// split K. Launches on `stream` (PyTorch's current stream) on device
// `device`; returns the cudaError_t of the launch.
extern "C" int fused_bn_relu_matmul_bf16_launch(const void* x, const float* a, const float* b,
                                                const void* w, void* out, int M, int K, int N,
                                                int bm, int bn, int split_k, int device,
                                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (split_k < 1 || split_k > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (BM, BN, STAGES)
  if (bm == 128 && bn == 128)
    err = launch<128, 128, 3>(x, a, b, w, out, M, K, N, split_k, device, s);
  else if (bm == 64 && bn == 128)
    err = launch<64, 128, 4>(x, a, b, w, out, M, K, N, split_k, device, s);
  else if (bm == 64 && bn == 64)
    err = launch<64, 64, 4>(x, a, b, w, out, M, K, N, split_k, device, s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
