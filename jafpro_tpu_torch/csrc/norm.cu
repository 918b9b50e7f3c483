// The CRN's ConvBlock norm for Hopper (sm_90a): SampleLayerNorm followed by
// LeakyReLU, forward and backward, two launches each.
//
// Replaces no TPU kernel: the JAX package writes this norm as jnp code
// (jafpro_tpu/models/common.py::SampleLayerNorm) and leaves its fusion to
// XLA.  In PyTorch the same code is ~14 elementwise and reduction kernels
// over float32 copies of the activation (about 72 bytes of device memory
// traffic per element); both CRNs run one after every convolution.
//
//   segment s = (sample n, group g): L = (C / G) H W contiguous elements
//   mu_s = mean, sigma_s = sqrt(sum (x - mu)^2 / (L - 1)), s_s = sigma + eps
//   y = (x - mu) / s * gamma_c + beta_c, rounded once to the input's type
//   out = y > 0 ? y : y * slope (of the rounded y, in float32, rounded)
//
// exactly the arithmetic of the plain form (jafpro_tpu_torch/ops/norm.py),
// in float32, except that the kernel multiplies by 1 / s where the plain
// form divides by s (within 1 float32 ulp).  Layouts: NCHW contiguous (any
// G; the channel of a segment's element o is o / HW) and, for G = 1,
// channels-last (the channel is o % C): "inner" is HW or 1.
//
// Bound: bytes.  One read and one write of the activation is the least the
// forward can move (4 B an element in bfloat16); this design reads twice
// (statistics, then the apply pass) and writes once, 6 B.  The backward
// reads x and dy twice and writes dx, 10 B against 6 B.
//
// Design.
//  - Statistics (sample_norm_stats): a segment is cut into K interleaved
//    chunks, one block each (K from the segment count, so that the grid
//    fills the card; one block for a small segment).  Each thread reads 16
//    bytes at a time, takes the vector's mean and M2 in registers and merges
//    them into its running (count, mean, M2) by Chan's formula; the block
//    merges its threads' triples in a fixed tree and writes one partial.
//    Every merge is in a fixed order: two runs give the same bits.  A thread
//    loads UNROLL vectors before it merges them (in the same order), so that
//    more loads are in flight (5% faster than one at a time at the served
//    CRN's shapes).
//  - Apply (sample_norm_apply): each block of a segment first merges the
//    segment's K partials (K <= 256, one a thread, the same fixed tree), then
//    normalises, applies the channel's affine, rounds, activates and stores,
//    16 bytes at a time.  Block 0 of a segment stores (mu, sigma) for the
//    backward.
//  - Backward, NCHW only (the wrapper makes a channels-last input
//    contiguous): sample_norm_bwd_reduce gives one warp each (row, chunk) of
//    a channel row (n, c) and forms A = sum g and B = sum g (x - mu), with
//    g = dy * slope(sign of the recomputed rounded pre-activation);
//    sample_norm_bwd_apply merges, per segment, sum g' = sum_c gamma_c A and
//    sum g' d = sum_c gamma_c B, and writes
//      dx = (g' - mean g') / s - d * sum(g' d) / ((L - 1) sigma s^2),
//    g' = gamma_c g, d = x - mu; block 0 of each group's first segment sums
//    dbeta_c = sum A and dgamma_c = sum B / s over the samples.
//
// Built with the repository's default flags (--fmad=false): the forward's
// pre-activation and the backward's recomputation of it are the same
// separately rounded operations, so the backward sees the forward's signs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // vectors a thread loads before it uses them
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Stat {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2) triples.
__device__ __forceinline__ Stat chan(Stat a, Stat b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  float n = a.n + b.n;
  float delta = b.mean - a.mean;
  float wb = b.n / n;
  Stat r;
  r.n = n;
  r.mean = a.mean + delta * wb;
  r.m2 = a.m2 + b.m2 + delta * delta * (a.n * wb);
  return r;
}

__device__ __forceinline__ Stat warp_merge(Stat s) {
  for (int o = 16; o > 0; o >>= 1) {
    Stat t;
    t.n = __shfl_down_sync(FULL, s.n, o);
    t.mean = __shfl_down_sync(FULL, s.mean, o);
    t.m2 = __shfl_down_sync(FULL, s.m2, o);
    s = chan(s, t);
  }
  return s;
}

// The block's merge of every thread's triple, returned to every thread.
__device__ Stat block_merge(Stat s) {
  __shared__ Stat part[WARPS];
  __shared__ Stat total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_merge(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    Stat t = lane < WARPS ? part[lane] : Stat{0.f, 0.f, 0.f};
    t = warp_merge(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ float2 warp_sum2(float2 v) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(FULL, v.x, o);
    v.y += __shfl_down_sync(FULL, v.y, o);
  }
  return v;
}

__device__ float2 block_sum2(float2 v) {
  __shared__ float2 part[WARPS];
  __shared__ float2 total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum2(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < WARPS ? part[lane] : make_float2(0.f, 0.f);
    t = warp_sum2(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The pre-activation, rounded to T and back: the forward's and the
// backward's recomputation are the same operations.
template <typename T>
__device__ __forceinline__ float rounded_pre(float x, float mean, float inv,
                                             float g, float b) {
  return to_f(from_f<T>((x - mean) * inv * g + b));
}

// 1 / (sigma + eps), the same bits in every kernel.
__device__ __forceinline__ float inv_scale(float sigma, float eps) {
  return 1.f / (sigma + eps);
}

// The channel (within the group) of a segment's element o, and o's place
// within its run of "inner" elements of one channel.
__device__ __forceinline__ void channel_of(int o, int inner, int cg, int& c,
                                           int& rem) {
  if (inner == 1) {
    c = o % cg;
    rem = 0;
  } else {
    c = o / inner;
    rem = o - c * inner;
  }
}

}  // namespace

// The kernels' names start with sample_norm_ (the profiler's trace is read
// by that name).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    sample_norm_stats(const T* __restrict__ x, int L, int K,
                      float* __restrict__ part) {
  const int s = blockIdx.y, k = blockIdx.x;
  const T* seg = x + (long long)s * L;
  const int nv = L / V;
  Stat acc{0.f, 0.f, 0.f};
  const int step = K * THREADS;
  for (int v0 = k * THREADS + threadIdx.x; v0 < nv; v0 += UNROLL * step) {
    Pack<T, V> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v0 + u * step < nv)
        p[u] = *reinterpret_cast<const Pack<T, V>*>(
            seg + (long long)(v0 + u * step) * V);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v0 + u * step >= nv) break;
      float f[V];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[j] = to_f(p[u].v[j]);
        sum += f[j];
      }
      const float m = sum * (1.f / V);
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - m;
        m2 += d * d;
      }
      acc = chan(acc, Stat{(float)V, m, m2});
    }
  }
  const Stat tot = block_merge(acc);
  if (threadIdx.x == 0) {
    float* out = part + 3 * ((long long)s * K + k);
    out[0] = tot.n;
    out[1] = tot.mean;
    out[2] = tot.m2;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    sample_norm_apply(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ part, int K, int L, int inner,
                      int cg, int G, int tiles, float eps, float slope,
                      float* __restrict__ stats, T* __restrict__ y) {
  const int s = blockIdx.y, t = blockIdx.x;
  Stat mine{0.f, 0.f, 0.f};
  if (threadIdx.x < K) {
    const float* p = part + 3 * ((long long)s * K + threadIdx.x);
    mine = Stat{p[0], p[1], p[2]};
  }
  const Stat tot = block_merge(mine);
  const float mean = tot.mean;
  const float sigma = sqrtf(tot.m2 / (float)(L - 1));
  const float inv = inv_scale(sigma, eps);
  if (t == 0 && threadIdx.x == 0) {
    stats[2 * s] = mean;
    stats[2 * s + 1] = sigma;
  }
  const int cb = (s % G) * cg;
  const float* gs = gamma + cb;
  const float* bs = beta + cb;
  const long long base = (long long)s * L;
  const int nv = L / V;
  const int step = tiles * THREADS;
  for (int v0 = t * THREADS + threadIdx.x; v0 < nv; v0 += UNROLL * step) {
    Pack<T, V> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v0 + u * step < nv)
        p[u] = *reinterpret_cast<const Pack<T, V>*>(x + base +
                                                    (v0 + u * step) * V);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v0 + u * step >= nv) break;
      const int o = (v0 + u * step) * V;
      int c, rem;
      channel_of(o, inner, cg, c, rem);
      Pack<T, V> q;
      float g = __ldg(gs + c), b = __ldg(bs + c);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float r = rounded_pre<T>(to_f(p[u].v[j]), mean, inv, g, b);
        q.v[j] = r > 0.f ? from_f<T>(r) : from_f<T>(r * slope);
        if (++rem == inner) {
          rem = 0;
          if (++c == cg) c = 0;
          g = __ldg(gs + c);
          b = __ldg(bs + c);
        }
      }
      *reinterpret_cast<Pack<T, V>*>(y + base + o) = q;
    }
  }
}

// One warp per (channel row r = n C + c, chunk j of J): A, B into
// rowpart[2 (r J + j)].
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    sample_norm_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const float* __restrict__ stats, int C, int cg,
                           int G, int HW, int J, long long items, float eps,
                           float slope, float* __restrict__ rowpart) {
  const long long item =
      ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= items) return;  // whole warps
  const long long r = item / J;
  const int j = (int)(item - r * J);
  const int n = (int)(r / C), c = (int)(r - (long long)n * C);
  const int s = n * G + c / cg;
  const float mean = stats[2 * s];
  const float inv = inv_scale(stats[2 * s + 1], eps);
  const float g = gamma[c], b = beta[c];
  const T* xr = x + r * HW;
  const T* dr = dy + r * HW;
  const int nv = HW / V;
  float2 acc = make_float2(0.f, 0.f);
  for (int v = j * 32 + lane; v < nv; v += J * 32) {
    Pack<T, V> px = *reinterpret_cast<const Pack<T, V>*>(xr + (long long)v * V);
    Pack<T, V> pd = *reinterpret_cast<const Pack<T, V>*>(dr + (long long)v * V);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xf = to_f(px.v[e]);
      const float rr = rounded_pre<T>(xf, mean, inv, g, b);
      const float gg = to_f(pd.v[e]) * (rr > 0.f ? 1.f : slope);
      acc.x += gg;
      acc.y += gg * (xf - mean);
    }
  }
  acc = warp_sum2(acc);
  if (lane == 0) {
    rowpart[2 * item] = acc.x;
    rowpart[2 * item + 1] = acc.y;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    sample_norm_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const float* __restrict__ stats,
                          const float* __restrict__ rowpart, int N, int C,
                          int cg, int G, int HW, int J, int L, int tiles,
                          float eps, float slope, T* __restrict__ dx,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta) {
  const int s = blockIdx.y, t = blockIdx.x;
  const int n = s / G, grp = s - n * G;
  const int cb = grp * cg;
  // sum g' and sum g' d over the segment's channel rows, in a fixed order
  float2 acc = make_float2(0.f, 0.f);
  const float* rp = rowpart + 2 * ((long long)n * C + cb) * J;
  for (int i = threadIdx.x; i < cg * J; i += THREADS) {
    const float gc = gamma[cb + i / J];
    acc.x += gc * rp[2 * i];
    acc.y += gc * rp[2 * i + 1];
  }
  acc = block_sum2(acc);
  const float mean = stats[2 * s], sigma = stats[2 * s + 1];
  const float inv = inv_scale(sigma, eps);
  const float sc = sigma + eps;
  const float mg = acc.x / (float)L;
  const float kd = acc.y / ((float)(L - 1) * sigma * sc * sc);
  const float* gs = gamma + cb;
  const float* bs = beta + cb;
  const long long base = (long long)s * L;
  const int nv = L / V;
  for (int v = t * THREADS + threadIdx.x; v < nv; v += tiles * THREADS) {
    const int o = v * V;
    int c, rem;
    channel_of(o, HW, cg, c, rem);
    Pack<T, V> px = *reinterpret_cast<const Pack<T, V>*>(x + base + o);
    Pack<T, V> pd = *reinterpret_cast<const Pack<T, V>*>(dy + base + o);
    Pack<T, V> q;
    float g = __ldg(gs + c), b = __ldg(bs + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xf = to_f(px.v[e]);
      const float rr = rounded_pre<T>(xf, mean, inv, g, b);
      const float gp = g * (to_f(pd.v[e]) * (rr > 0.f ? 1.f : slope));
      q.v[e] = from_f<T>((gp - mg) * inv - (xf - mean) * kd);
      if (++rem == HW) {
        rem = 0;
        if (++c == cg) c = 0;
        g = __ldg(gs + c);
        b = __ldg(bs + c);
      }
    }
    *reinterpret_cast<Pack<T, V>*>(dx + base + o) = q;
  }
  if (t == 0 && n == 0) {
    for (int i = threadIdx.x; i < cg; i += THREADS) {
      const int c = cb + i;
      float sa = 0.f, sb = 0.f;
      for (int m = 0; m < N; ++m) {
        const float* q = rowpart + 2 * ((long long)m * C + c) * J;
        float pa = 0.f, pb = 0.f;
        for (int jj = 0; jj < J; ++jj) {
          pa += q[2 * jj];
          pb += q[2 * jj + 1];
        }
        sa += pa;
        sb += pb * inv_scale(stats[2 * (m * G + grp) + 1], eps);
      }
      dgamma[c] = sb;
      dbeta[c] = sa;
    }
  }
}

namespace {

template <typename T, int V>
int forward_t(const void* x, const float* gamma, const float* beta, void* y,
              float* part, float* stats, int S, int L, int K, int tiles,
              int inner, int cg, int G, float eps, float slope,
              cudaStream_t stream) {
  sample_norm_stats<T, V><<<dim3(K, S), THREADS, 0, stream>>>(
      static_cast<const T*>(x), L, K, part);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  sample_norm_apply<T, V><<<dim3(tiles, S), THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, part, K, L, inner, cg, G, tiles,
      eps, slope, stats, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T, int V>
int backward_t(const void* x, const void* dy, const float* gamma,
               const float* beta, const float* stats, float* rowpart,
               void* dx, float* dgamma, float* dbeta, int N, int C, int G,
               int HW, int J, int tiles, float eps, float slope,
               cudaStream_t stream) {
  const int cg = C / G;
  const long long items = (long long)N * C * J;
  const long long blocks = (items * 32 + THREADS - 1) / THREADS;
  sample_norm_bwd_reduce<T, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta, stats,
      C, cg, G, HW, J, items, eps, slope, rowpart);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  sample_norm_bwd_apply<T, V><<<dim3(tiles, N * G), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta, stats,
      rowpart, N, C, cg, G, HW, J, cg * HW, tiles, eps, slope,
      static_cast<T*>(dx), dgamma, dbeta);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vec: 1 for 16-byte accesses (L, and HW in
// the backward, a multiple of 16 / sizeof(T), the pointers 16-byte
// aligned), else 0.  Returns the first nonzero cudaGetLastError().
extern "C" int sample_norm_forward(const void* x, const float* gamma,
                                   const float* beta, void* y, float* part,
                                   float* stats, int S, int L, int K,
                                   int tiles, int inner, int cg, int G,
                                   int dtype, int vec, float eps, float slope,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? forward_t<float, 4>(x, gamma, beta, y, part, stats, S, L, K,
                                     tiles, inner, cg, G, eps, slope, st)
               : forward_t<float, 1>(x, gamma, beta, y, part, stats, S, L, K,
                                     tiles, inner, cg, G, eps, slope, st);
  if (dtype == 1)
    return vec ? forward_t<__nv_bfloat16, 8>(x, gamma, beta, y, part, stats,
                                             S, L, K, tiles, inner, cg, G,
                                             eps, slope, st)
               : forward_t<__nv_bfloat16, 1>(x, gamma, beta, y, part, stats,
                                             S, L, K, tiles, inner, cg, G,
                                             eps, slope, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sample_norm_backward(const void* x, const void* dy,
                                    const float* gamma, const float* beta,
                                    const float* stats, float* rowpart,
                                    void* dx, float* dgamma, float* dbeta,
                                    int N, int C, int G, int HW, int J,
                                    int tiles, int dtype, int vec, float eps,
                                    float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? backward_t<float, 4>(x, dy, gamma, beta, stats, rowpart, dx,
                                      dgamma, dbeta, N, C, G, HW, J, tiles,
                                      eps, slope, st)
               : backward_t<float, 1>(x, dy, gamma, beta, stats, rowpart, dx,
                                      dgamma, dbeta, N, C, G, HW, J, tiles,
                                      eps, slope, st);
  if (dtype == 1)
    return vec ? backward_t<__nv_bfloat16, 8>(x, dy, gamma, beta, stats,
                                              rowpart, dx, dgamma, dbeta, N,
                                              C, G, HW, J, tiles, eps, slope,
                                              st)
               : backward_t<__nv_bfloat16, 1>(x, dy, gamma, beta, stats,
                                              rowpart, dx, dgamma, dbeta, N,
                                              C, G, HW, J, tiles, eps, slope,
                                              st);
  return (int)cudaErrorInvalidValue;
}
