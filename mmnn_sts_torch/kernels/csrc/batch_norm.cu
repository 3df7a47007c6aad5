// Train-mode BatchNorm of channels-last activations: batch statistics,
// running-statistic update, normalisation (+ ReLU) and their backward, four
// kernels of one pass each.
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into a few loops of one program. PyTorch's eager ops run each
// BatchNorm as some twenty kernels forward and as many again backward (the
// casts, two means, the clamp, the running update, the fold, the normalise;
// their reductions and products), and the DenseNet superstep is bound by
// that count of launches, not by bytes or FLOPs. Here a BatchNorm is two
// launches forward and two backward. ops/batch_norm.py binds them under
// autograd; models/common.BatchNorm keeps its plain PyTorch version, which
// the CPU tests hold against the JAX package and the `cuda` tests hold
// these kernels against.
//
// Layout. x is (rows, C) row-major: a channels-last (N, *spatial, C)
// activation seen whole, or the clinical MLP's (N, C). `vox` rows belong
// to one sample, so row r's sample-mask entry is mask[r / vox] (0 or 1).
// A CTA's threads are `lanes` channel lanes by `row_lanes` row lanes: the
// thread of lane g reads V contiguous channels (16 bytes where it can),
// the lanes of one row lane read one row segment together, and each row
// lane walks rows row_lanes apart. The grid is (row blocks, column blocks):
// blockIdx.y takes a column of lanes * V channels, blockIdx.x a block of
// `rows_per_cta` rows. Every pass reads its operands once.
//
// Determinism. A sum over rows is a per-thread sum in row order, then a
// fixed tree over the row lanes in shared memory, then, across the CTAs of
// a column where it has several, a fixed strided sum in the last CTA to
// finish (found with a ticket counter that it resets itself, so a captured
// CUDA graph replays it): no float atomics, and the same bits from run to
// run for one shape. The last CTA's threads then finalize a channel each,
// with its operands loaded at the start.
//
// Numerics are the plain path's (models/common.compute_batch_stats,
// update_running_stats, BatchNorm.forward, ops/fused_dense.bn_relu_conv1x1):
// sums in float32 (bf16 read and widened in registers), mean = sum / n,
// var = max(E[x^2] - mean^2, 0), the unbiased factor, a masked n with
// identity statistics when no sample is valid, the running update at the
// given momentum (not on a remat recompute), rstd = 1 / sqrt(var + eps),
// a = rstd * weight, b = bias - mean * a, and out = (x - mean) * a + bias
// in float32, masked rows zeroed, rounded once to the output's type, then
// the ReLU (a NaN stays NaN). The elementwise steps use __f*_rn so that
// nvcc contracts nothing the plain path rounds. Only the order of the
// float32 sums differs from PyTorch's reductions.
//
// The backward is the chain that autograd takes through the plain graph:
// gz = g (0 where the ReLU's output is <= 0, as threshold_backward) times
// the row's mask; per channel dbias = sum gz, dweight = sum gz (x - mean)
// * rstd; the variance's gradient through torch.maximum (all of it where
// E[x^2] - mean^2 > 0, half at 0, none below, none without a valid
// sample); then dx = gz * a + m (c1 + c2 x) with c1 = dmean / n and c2 =
// 2 dE[x^2] / n, rounded once to x's type. The fused bottleneck's
// statistics take (da, db) of its folded a, b the same way, with no gz
// term (bn_backward_dx_kernel without g).
//
// What bounds it on an H100: bytes. A pass reads (and the normalise and
// dx passes write) rows x C elements, 2 bytes in bf16; DenseNet121's
// largest BatchNorm, norm0 at batch 8 (262,144 rows x 64), is 33.5 MB a
// pass, ~10 us at 3.35 TB/s; most are under 1 MB, where a launch's
// latency sets the time. ops/batch_norm.plan sizes the grid: about two
// waves of CTAs for the reducing kernels (so the last CTA combines few
// partials) and four for the others, each thread walking at least four
// row passes, four rows' loads in flight at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;      // threads of a CTA at most
constexpr int MAX_VEC = 8;      // channels a thread reads at once
constexpr int UNROLL = 4;       // rows whose loads a thread keeps in flight
constexpr int MAX_SLOTS = 64;   // ticket rows: one a stream (ops/batch_norm)
constexpr int MAX_COLUMNS = 256;  // column blocks of a launch
constexpr int STATS_ROWS = 6;   // per-channel rows of the stats buffer

// the stats buffer: STATS_ROWS rows of C floats, then n and any_valid
enum StatsRow { MEAN = 0, VAR = 1, RSTD = 2, A = 3, B = 4, FVAR = 5 };

__device__ unsigned int bn_tickets[MAX_SLOTS * MAX_COLUMNS];

struct Shape {
  int rows, channels, vox;        // vox: rows of one sample
  int lanes, row_lanes, rows_per_cta;
};

// ---------------------------------------------------------------- loads

template <typename T>
struct Io;

template <>
struct Io<float> {
  template <int V>
  static __device__ __forceinline__ void load(const float* p, float (&v)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 t = reinterpret_cast<const float4*>(p)[k];
        v[4 * k] = t.x, v[4 * k + 1] = t.y, v[4 * k + 2] = t.z,
        v[4 * k + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = p[i];
    }
  }
  template <int V>
  static __device__ __forceinline__ void store(float* p, const float (&v)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        reinterpret_cast<float4*>(p)[k] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = v[i];
    }
  }
};

__device__ __forceinline__ void unpack(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

template <>
struct Io<__nv_bfloat16> {
  template <int V>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[V]) {
    if constexpr (V == 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      unpack(t.x, v[0], v[1]), unpack(t.y, v[2], v[3]);
      unpack(t.z, v[4], v[5]), unpack(t.w, v[6], v[7]);
    } else if constexpr (V == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      unpack(t.x, v[0], v[1]), unpack(t.y, v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
    }
  }
  template <int V>
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[V]) {
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(
          pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
          pack(v[6], v[7]));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(pack(v[0], v[1]), pack(v[2], v[3]));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
    }
  }
};

// V floats written by other CTAs of this launch: through L2, past L1
template <int V>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p) + k);
      v[4 * k] = t.x, v[4 * k + 1] = t.y, v[4 * k + 2] = t.z,
      v[4 * k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldcg(p + i);
  }
}

// ------------------------------------------------------- thread geometry

struct Place {
  int lane_g, lane_r, c0, r_begin, r_end;
  bool active;  // the thread's V channels exist
};

__device__ __forceinline__ Place place(const Shape& s, int vec) {
  Place q;
  q.lane_g = threadIdx.x % s.lanes;
  q.lane_r = threadIdx.x / s.lanes;
  const int group = blockIdx.y * s.lanes + q.lane_g;
  q.active = group < s.channels / vec;
  q.c0 = group * vec;
  q.r_begin = blockIdx.x * s.rows_per_cta + q.lane_r;
  q.r_end = min(s.rows, (blockIdx.x + 1) * s.rows_per_cta);
  return q;
}

// Sums acc[K][V] over the row lanes, in a fixed tree, into the threads of
// row lane 0 (the others' acc is left partial). `red` holds K * V * BLOCK
// floats.
template <int K, int V>
__device__ __forceinline__ void reduce_rows(float (&acc)[K][V], float* red,
                                            const Shape& s, const Place& q) {
  const int n = s.row_lanes * s.lanes;
  const int me = q.lane_r * s.lanes + q.lane_g;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) red[(k * V + i) * n + me] = acc[k][i];
  for (int half = s.row_lanes >> 1; half > 0; half >>= 1) {
    __syncthreads();
    if (q.lane_r < half) {
      const int peer = me + half * s.lanes;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[k][i] += red[(k * V + i) * n + peer];
          red[(k * V + i) * n + me] = acc[k][i];
        }
    }
  }
  __syncthreads();
}

// The partial sums of the column's CTAs, per thread in CTA order (row lane
// r takes CTAs r, r + row_lanes, ...; UNROLL CTAs' loads in flight), into
// acc; reduce_rows then sums them over the row lanes.
template <int V>
__device__ __forceinline__ void sum_partials(float (&acc)[2][V],
                                             const float* partial,
                                             const Shape& s, const Place& q) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[0][i] = acc[1][i] = 0.f;
  if (!q.active) return;
  const int C = s.channels;
  for (int b = q.lane_r; b < (int)gridDim.x; b += UNROLL * s.row_lanes) {
    float p[UNROLL][2][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int cta = b + u * s.row_lanes;
      if (cta < (int)gridDim.x) {
        const float* row = partial + (long long)cta * 2 * C + q.c0;
        load_cg<V>(row, p[u][0]);
        load_cg<V>(row + C, p[u][1]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) p[u][0][i] = p[u][1][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[0][i] += p[u][0][i];
        acc[1][i] += p[u][1][i];
      }
  }
}

// After reduce_rows: the column's sum k of channel j (of lanes * V) as
// row lane 0 left it in `red`.
template <int V>
__device__ __forceinline__ float column_sum(const float* red, const Shape& s,
                                           int k, int j) {
  return red[(k * V + j % V) * (s.row_lanes * s.lanes) + j / V];
}

// Whether this CTA is the last of its column to get here; its partials
// (written before the call) are then visible to it, and the column's
// ticket is back at 0 for the next launch.
__device__ __forceinline__ bool last_of_column(int slot) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* ticket = &bn_tickets[slot * MAX_COLUMNS + blockIdx.y];
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The column's sums across its CTAs, where it has more than one: each CTA
// stores its own (row lane 0's acc), and the last to finish sums them all
// (sum_partials, reduce_rows), leaving them where reduce_rows leaves one
// CTA's. Returns false in the CTAs that are done.
template <int V>
__device__ __forceinline__ bool combine_column(float (&acc)[2][V], float* red,
                                               float* partial, const Shape& s,
                                               const Place& q, int slot) {
  if (gridDim.x == 1) return true;
  if (q.lane_r == 0 && q.active) {
    float* mine = partial + (long long)blockIdx.x * 2 * s.channels + q.c0;
    Io<float>::template store<V>(mine, acc[0]);
    Io<float>::template store<V>(mine + s.channels, acc[1]);
  }
  if (!last_of_column(slot)) return false;
  sum_partials<V>(acc, partial, s, q);
  reduce_rows<2, V>(acc, red, s, q);
  return true;
}

// The sum of mask[0, samples) over the CTA: whole numbers, exact in any
// order.
__device__ __forceinline__ float count_valid(const float* mask, int samples) {
  __shared__ float warps[BLOCK / 32];
  float c = 0.f;
  for (int i = threadIdx.x; i < samples; i += blockDim.x) c += mask[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = c;
  __syncthreads();
  c = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) c += warps[w];
  return c;
}

// ------------------------------------------------------------- kernels

// Kernel 1: per-channel sums of x and x^2 (x masked) a CTA, then in the
// last CTA of each column the statistics, the running update (where
// `update` and some sample is valid), and the stats buffer and the folded
// a, b (where a_out is given).
template <typename T, int V>
__global__ void __launch_bounds__(BLOCK)
bn_stats_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                Shape s, const float* __restrict__ weight,
                const float* __restrict__ bias, float* running_mean,
                float* running_var, int update, float eps, float momentum,
                float one_minus, float unbiased, float* partial,
                float* stats, float* a_out, float* b_out, int slot) {
  __shared__ float red[2 * MAX_VEC * BLOCK];
  const Place q = place(s, V);
  const int C = s.channels;
  // the channel this thread finalizes, if its CTA is the column's last:
  // its operands loaded now, beside the rows
  const int j = threadIdx.x, c = blockIdx.y * s.lanes * V + j;
  const bool finalizes = j < s.lanes * V && c < C;
  float rm = 0.f, rv = 0.f, w = 0.f, bi = 0.f;
  if (finalizes) {
    rm = running_mean[c], rv = running_var[c], w = weight[c], bi = bias[c];
  }
  float acc[2][V] = {};
  if (q.active) {
    for (int r = q.r_begin; r < q.r_end; r += UNROLL * s.row_lanes) {
      float v[UNROLL][V], m[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = r + u * s.row_lanes;
        if (row < q.r_end) {
          Io<T>::template load<V>(x + (long long)row * C + q.c0, v[u]);
          m[u] = mask ? mask[row / s.vox] : 1.f;
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[u][i] = 0.f;
          m[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xm = v[u][i] * m[u];
          acc[0][i] += xm;
          acc[1][i] = fmaf(xm, v[u][i], acc[1][i]);
        }
    }
  }
  reduce_rows<2, V>(acc, red, s, q);
  if (!combine_column<V>(acc, red, partial, s, q, slot)) return;
  const float valid =
      mask ? __fmul_rn(count_valid(mask, s.rows / s.vox), (float)s.vox) : 0.f;
  // one thread a channel of the column from here
  if (!finalizes) return;
  const bool any = mask ? valid > 0.f : true;
  const float n = mask ? fmaxf(valid, 1.f) : (float)s.rows;
  if (c == 0) {
    stats[STATS_ROWS * C] = n;
    stats[STATS_ROWS * C + 1] = any ? 1.f : 0.f;
  }
  const float factor =
      mask ? __fdiv_rn(valid, fmaxf(__fsub_rn(valid, 1.f), 1.f)) : unbiased;
  float mean = __fdiv_rn(column_sum<V>(red, s, 0, j), n);
  const float diff = __fsub_rn(__fdiv_rn(column_sum<V>(red, s, 1, j), n),
                               __fmul_rn(mean, mean));
  // torch.maximum(diff, 0) and its gradient's share to diff
  float var = diff <= 0.f ? 0.f : diff;
  float fvar = diff > 0.f ? 1.f : diff == 0.f ? 0.5f : diff < 0.f ? 0.f : 1.f;
  if (!any) mean = 0.f, var = 1.f, fvar = 0.f;
  if (update && any) {
    running_mean[c] = __fadd_rn(__fmul_rn(momentum, rm),
                                __fmul_rn(one_minus, mean));
    running_var[c] = __fadd_rn(__fmul_rn(momentum, rv),
                               __fmul_rn(one_minus, __fmul_rn(var, factor)));
  }
  const float rstd = 1.f / sqrtf(__fadd_rn(var, eps));
  const float a = __fmul_rn(rstd, w);
  const float b = __fsub_rn(bi, __fmul_rn(mean, a));
  stats[MEAN * C + c] = mean;
  stats[VAR * C + c] = var;
  stats[RSTD * C + c] = rstd;
  stats[A * C + c] = a;
  stats[B * C + c] = b;
  stats[FVAR * C + c] = fvar;
  if (a_out) a_out[c] = a, b_out[c] = b;
}

// Kernel 2: y = (x - mean) * a + bias, masked rows zeroed, rounded to y's
// type, then the ReLU where `relu`. Train mode reads mean and a from the
// stats buffer; eval mode (stats null) folds the running statistics.
template <typename T, int V>
__global__ void __launch_bounds__(BLOCK)
bn_normalize_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const float* __restrict__ mask, Shape s,
                    const float* __restrict__ stats,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias,
                    const float* __restrict__ running_mean,
                    const float* __restrict__ running_var, float eps,
                    int relu) {
  const Place q = place(s, V);
  if (!q.active) return;
  const int C = s.channels;
  float mean[V], a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = q.c0 + i;
    if (stats) {
      mean[i] = stats[MEAN * C + c], a[i] = stats[A * C + c];
    } else {
      mean[i] = running_mean[c];
      a[i] = __fmul_rn(1.f / sqrtf(__fadd_rn(running_var[c], eps)),
                       weight[c]);
    }
    b[i] = bias[c];
  }
  for (int r = q.r_begin; r < q.r_end; r += UNROLL * s.row_lanes) {
    float v[UNROLL][V], m[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = r + u * s.row_lanes;
      if (row < q.r_end) {
        Io<T>::template load<V>(x + (long long)row * C + q.c0, v[u]);
        m[u] = mask ? mask[row / s.vox] : 1.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = r + u * s.row_lanes;
      if (row >= q.r_end) break;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t = __fadd_rn(__fmul_rn(__fsub_rn(v[u][i], mean[i]), a[i]),
                            b[i]);
        if (mask) t = __fmul_rn(t, m[u]);
        o[i] = relu && t <= 0.f ? 0.f : t;
      }
      Io<T>::template store<V>(y + (long long)row * C + q.c0, o);
    }
  }
}

// One row's operands of the backward: g (where G), the ReLU's output y
// (where RELU), x and the row's mask; loaded for UNROLL rows before any is
// used (`load`), then gz = g, 0 where y <= 0 (threshold_backward), times
// the mask (`gz`). G and RELU are compile-time, so a kernel without them
// holds no registers for them.
template <typename T, int V, bool G, bool RELU>
struct GradRows {
  float g[G ? UNROLL : 1][V], y[RELU ? UNROLL : 1][V], x[UNROLL][V],
      m[UNROLL];

  __device__ __forceinline__ void load(const T* gp, const T* yp, const T* xp,
                                       const float* mask, const Shape& s,
                                       const Place& q, int r) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = r + u * s.row_lanes;
      if (row < q.r_end) {
        const long long off = (long long)row * s.channels + q.c0;
        if constexpr (G) Io<T>::template load<V>(gp + off, g[u]);
        if constexpr (RELU) Io<T>::template load<V>(yp + off, y[u]);
        Io<T>::template load<V>(xp + off, x[u]);
        m[u] = mask ? mask[row / s.vox] : 1.f;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if constexpr (G) g[u][i] = 0.f;
          if constexpr (RELU) y[u][i] = 0.f;
          x[u][i] = 0.f;
        }
        m[u] = 0.f;
      }
    }
  }

  __device__ __forceinline__ float gz(int u, int i) const {
    if constexpr (RELU) {
      return __fmul_rn(y[u][i] <= 0.f ? 0.f : g[u][i], m[u]);
    } else {
      return __fmul_rn(g[u][i], m[u]);
    }
  }
};

// Kernel 3: per-channel sums of gz and gz (x - mean) a CTA, then in the
// last CTA of each column dweight, dbias and the coefficients c1, c2 of
// dx (the `coef` buffer: c1 then c2, C each).
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(BLOCK)
bn_backward_sums_kernel(const T* __restrict__ g, const T* __restrict__ y,
                        const T* __restrict__ x,
                        const float* __restrict__ mask, Shape s,
                        const float* __restrict__ stats,
                        const float* __restrict__ weight, float* partial,
                        float* coef, float* dweight, float* dbias, int slot) {
  __shared__ float red[2 * MAX_VEC * BLOCK];
  const Place q = place(s, V);
  const int C = s.channels;
  // the channel this thread finalizes, if its CTA is the column's last:
  // its operands loaded now, beside the rows
  const int j = threadIdx.x, c = blockIdx.y * s.lanes * V + j;
  const bool finalizes = j < s.lanes * V && c < C;
  float mean_c = 0.f, rstd = 0.f, a = 0.f, fvar = 0.f, w = 0.f;
  if (finalizes) {
    mean_c = stats[MEAN * C + c], rstd = stats[RSTD * C + c];
    a = stats[A * C + c], fvar = stats[FVAR * C + c], w = weight[c];
  }
  const float n = stats[STATS_ROWS * C];
  const bool any = stats[STATS_ROWS * C + 1] != 0.f;
  float acc[2][V] = {};
  if (q.active) {
    float mean[V];
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = stats[MEAN * C + q.c0 + i];
    for (int r = q.r_begin; r < q.r_end; r += UNROLL * s.row_lanes) {
      GradRows<T, V, true, RELU> rows;
      rows.load(g, y, x, mask, s, q, r);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float gz = rows.gz(u, i);
          acc[0][i] += gz;
          acc[1][i] = fmaf(gz, __fsub_rn(rows.x[u][i], mean[i]), acc[1][i]);
        }
    }
  }
  reduce_rows<2, V>(acc, red, s, q);
  if (!combine_column<V>(acc, red, partial, s, q, slot)) return;
  // one thread a channel of the column from here
  if (!finalizes) return;
  const float sum_gz = column_sum<V>(red, s, 0, j);
  const float sum_gzx = column_sum<V>(red, s, 1, j);
  dbias[c] = sum_gz;
  dweight[c] = __fmul_rn(sum_gzx, rstd);
  // d rsqrt(var + eps) = -rstd^3 / 2, through max(diff, 0) by FVAR
  const float dr = __fmul_rn(sum_gzx, w);
  const float ddiff = __fmul_rn(
      __fmul_rn(__fmul_rn(-0.5f, dr), __fmul_rn(__fmul_rn(rstd, rstd), rstd)),
      fvar);
  const float dmean = any ? -__fmul_rn(a, sum_gz) - 2.f * mean_c * ddiff
                          : 0.f;
  coef[c] = dmean / n;
  coef[C + c] = 2.f * ddiff / n;
}

// Kernel 4: dx = gz * a + m (c1 + c2 x), rounded to x's type. Without g
// (the fused bottleneck's statistics), dx = m (c1 + c2 x) with c1, c2
// computed here from the gradients (da, db) of its folded a, b, and the
// CTAs of row block 0 write dscale.
template <typename T, int V, bool G, bool RELU>
__global__ void __launch_bounds__(BLOCK)
bn_backward_dx_kernel(const T* __restrict__ g, const T* __restrict__ y,
                      const T* __restrict__ x, T* __restrict__ dx,
                      const float* __restrict__ mask, Shape s,
                      const float* __restrict__ stats,
                      const float* __restrict__ coef,
                      const float* __restrict__ da,
                      const float* __restrict__ db,
                      const float* __restrict__ scale,
                      float* __restrict__ dscale) {
  const Place q = place(s, V);
  if (!q.active) return;
  const int C = s.channels;
  float a[V], c1[V], c2[V];
  const float n = stats[STATS_ROWS * C];
  const bool any = stats[STATS_ROWS * C + 1] != 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = q.c0 + i;
    a[i] = stats[A * C + c];
    if constexpr (G) {
      c1[i] = coef[c], c2[i] = coef[C + c];
      continue;
    }
    // a = scale * rstd, b = bias - mean * a
    const float mean = stats[MEAN * C + c], rstd = stats[RSTD * C + c];
    const float da_all = __fsub_rn(da[c], __fmul_rn(db[c], mean));
    if (blockIdx.x == 0 && q.lane_r == 0) dscale[c] = __fmul_rn(da_all, rstd);
    const float dr = __fmul_rn(da_all, scale[c]);
    const float ddiff = __fmul_rn(
        __fmul_rn(__fmul_rn(-0.5f, dr), __fmul_rn(__fmul_rn(rstd, rstd), rstd)),
        stats[FVAR * C + c]);
    const float dmean =
        any ? -__fmul_rn(db[c], a[i]) - 2.f * mean * ddiff : 0.f;
    c1[i] = dmean / n;
    c2[i] = 2.f * ddiff / n;
  }
  for (int r = q.r_begin; r < q.r_end; r += UNROLL * s.row_lanes) {
    GradRows<T, V, G, RELU> rows;
    rows.load(g, y, x, mask, s, q, r);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = r + u * s.row_lanes;
      if (row >= q.r_end) break;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float stat = __fmul_rn(rows.m[u], fmaf(c2[i], rows.x[u][i],
                                                     c1[i]));
        if constexpr (G) {
          o[i] = fmaf(rows.gz(u, i), a[i], stat);
        } else {
          o[i] = stat;
        }
      }
      Io<T>::template store<V>(dx + (long long)row * C + q.c0, o);
    }
  }
}

// ------------------------------------------------------------- dispatch

template <typename T>
struct Type {
  using type = T;
};
template <int V>
struct Vec {
  static constexpr int value = V;
};

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Calls f(Flag<b>{}) for the runtime b.
template <typename F>
cudaError_t with_flag(bool b, F&& f) {
  return b ? f(Flag<true>{}) : f(Flag<false>{});
}

// Calls f(Type<T>{}, Vec<V>{}) for the runtime dtype (0 float32,
// 1 bfloat16) and vec (8, 4 or 1).
template <typename F>
cudaError_t dispatch(int dtype, int vec, F&& f) {
  if (dtype == 0) {
    if (vec == 8) return f(Type<float>{}, Vec<8>{});
    if (vec == 4) return f(Type<float>{}, Vec<4>{});
    if (vec == 1) return f(Type<float>{}, Vec<1>{});
  } else if (dtype == 1) {
    if (vec == 8) return f(Type<__nv_bfloat16>{}, Vec<8>{});
    if (vec == 4) return f(Type<__nv_bfloat16>{}, Vec<4>{});
    if (vec == 1) return f(Type<__nv_bfloat16>{}, Vec<1>{});
  }
  return cudaErrorInvalidValue;
}

cudaError_t check(const Shape& s, int vec, int grid_x, int grid_y, int slot) {
  if (s.rows < 1 || s.channels < 1 || s.vox < 1 || s.rows % s.vox ||
      s.channels % vec || s.lanes < 1 || s.row_lanes < 1 ||
      s.lanes * s.row_lanes > BLOCK || (s.lanes * s.row_lanes) % 32 ||
      (s.row_lanes & (s.row_lanes - 1)) || grid_x < 1 || grid_y < 1 ||
      grid_y > MAX_COLUMNS || (long long)grid_y * s.lanes * vec < s.channels ||
      (long long)grid_x * s.rows_per_cta < s.rows || slot < 0 ||
      slot >= MAX_SLOTS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t finish(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Each entry launches on `stream` (PyTorch's current stream) of `device`
// with the grid (grid_x, grid_y) and the thread geometry of
// ops/batch_norm.plan, and returns the cudaError_t of the launch. Pointers
// that a mode does not use are null. dtype: 0 float32, 1 bfloat16.

extern "C" int bn_stats_launch(
    const void* x, int dtype, const float* mask, int rows, int channels,
    int vox, const float* weight, const float* bias, float* running_mean,
    float* running_var, int update, float eps, float momentum,
    float one_minus, float unbiased, float* partial, float* stats,
    float* a_out, float* b_out, int vec, int grid_x, int grid_y, int lanes,
    int row_lanes, int rows_per_cta, int slot, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{rows, channels, vox, lanes, row_lanes, rows_per_cta};
  err = check(s, vec, grid_x, grid_y, slot);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, grid_y);
  const int threads = lanes * row_lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dispatch(dtype, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(v)::value;
    bn_stats_kernel<T, V><<<grid, threads, 0, st>>>(
        static_cast<const T*>(x), mask, s, weight, bias, running_mean,
        running_var, update, eps, momentum, one_minus, unbiased, partial,
        stats, a_out, b_out, slot);
    return cudaSuccess;
  });
  return (int)finish(err);
}

extern "C" int bn_normalize_launch(
    const void* x, void* y, int dtype, const float* mask, int rows,
    int channels, int vox, const float* stats, const float* weight,
    const float* bias, const float* running_mean, const float* running_var,
    float eps, int relu, int vec, int grid_x, int grid_y, int lanes,
    int row_lanes, int rows_per_cta, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{rows, channels, vox, lanes, row_lanes, rows_per_cta};
  err = check(s, vec, grid_x, grid_y, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, grid_y);
  const int threads = lanes * row_lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dispatch(dtype, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(v)::value;
    bn_normalize_kernel<T, V><<<grid, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mask, s, stats,
        weight, bias, running_mean, running_var, eps, relu);
    return cudaSuccess;
  });
  return (int)finish(err);
}

extern "C" int bn_backward_sums_launch(
    const void* g, const void* y, const void* x, int dtype,
    const float* mask, int rows, int channels, int vox, const float* stats,
    const float* weight, float* partial, float* coef, float* dweight,
    float* dbias, int vec, int grid_x, int grid_y, int lanes, int row_lanes,
    int rows_per_cta, int slot, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{rows, channels, vox, lanes, row_lanes, rows_per_cta};
  err = check(s, vec, grid_x, grid_y, slot);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, grid_y);
  const int threads = lanes * row_lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dispatch(dtype, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(v)::value;
    return with_flag(y != nullptr, [&](auto relu) {
      bn_backward_sums_kernel<T, V, decltype(relu)::value>
          <<<grid, threads, 0, st>>>(
              static_cast<const T*>(g), static_cast<const T*>(y),
              static_cast<const T*>(x), mask, s, stats, weight, partial,
              coef, dweight, dbias, slot);
      return cudaSuccess;
    });
  });
  return (int)finish(err);
}

extern "C" int bn_backward_dx_launch(
    const void* g, const void* y, const void* x, void* dx, int dtype,
    const float* mask, int rows, int channels, int vox, const float* stats,
    const float* coef, const float* da, const float* db, const float* scale,
    float* dscale, int vec, int grid_x, int grid_y, int lanes, int row_lanes,
    int rows_per_cta, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{rows, channels, vox, lanes, row_lanes, rows_per_cta};
  err = check(s, vec, grid_x, grid_y, 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, grid_y);
  const int threads = lanes * row_lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y && !g) return (int)cudaErrorInvalidValue;  // a ReLU needs g
  err = dispatch(dtype, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(v)::value;
    if (!g) {
      bn_backward_dx_kernel<T, V, false, false><<<grid, threads, 0, st>>>(
          nullptr, nullptr, static_cast<const T*>(x), static_cast<T*>(dx),
          mask, s, stats, coef, da, db, scale, dscale);
      return cudaSuccess;
    }
    return with_flag(y != nullptr, [&](auto relu) {
      bn_backward_dx_kernel<T, V, true, decltype(relu)::value>
          <<<grid, threads, 0, st>>>(
              static_cast<const T*>(g), static_cast<const T*>(y),
              static_cast<const T*>(x), static_cast<T*>(dx), mask, s, stats,
              coef, da, db, scale, dscale);
      return cudaSuccess;
    });
  });
  return (int)finish(err);
}
