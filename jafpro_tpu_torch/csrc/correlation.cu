// FlowNetC cost-volume correlation for Hopper (sm_90a), forward and backward.
//
// Replaces jafpro_tpu/ops/correlation.py::correlation (the JAX package's
// lax.scan over displacements, its "TPU-native equivalent of the reference's
// correlation_cuda") and, for the backward, XLA's autodiff of that scan.
//
//   out[b, k, y, x] = (1/C) sum_c f1[b, c, y, x] * f2[b, c, y + dy_k, x + dx_k]
//
// with f2 zero outside the image, displacements dy, dx in
// {-md, -md + s2, ..., md} (n = 2 md / s2 + 1 of each) and k = iy * n + jx,
// dy-major: the reference CUDA layout.  Tensors are NCHW, contiguous, float32
// or bfloat16; every sum is accumulated in float32 and the result is written
// in the input's type (as jnp.mean of a bf16 product returns bf16).
//
// Backward, both as gathers, so no atomics and a deterministic result:
//   grad_f1[b, c, p] = (1/C) sum_k g[b, k, p] * f2[b, c, p + d_k]
//   grad_f2[b, c, q] = (1/C) sum_k g[b, k, q - d_k] * f1[b, c, q - d_k]
// where a p + d_k (forward, grad_f1) or q - d_k (grad_f2) outside the image
// contributes nothing: it is staged as zero.
//
// Bound: the operations.  At FlowNetC's training shape (B 8, C 256, 32 x 32,
// md 20, s2 2, D 441) the forward is 2 B C H W D = 1.85 GFLOP of float32
// multiply-adds against 16.8 MB of inputs and 14.5 MB of output; the
// backward twice the operations.  On the CUDA cores' float32 rate (67
// TFLOP/s) that is 0.028 ms forward and 0.055 ms backward; at 3.35 TB/s the
// bytes take 0.009 and 0.014 ms.
//
// Design (simple first): one thread per output pixel, a tile of 8 x 32
// pixels per block, so a warp reads a 32-wide row of shared memory.
//  - Forward: grid (tiles, dy index, batch).  For one dy a block stages, one
//    chunk of 16 channels at a time, its f1 tile and the rows of f2 that the
//    tile's pixels see at that dy, widened by md on each side (zero-padded).
//    Each thread keeps its n accumulators (one per dx) in registers; a dx
//    step is one shared-memory read of f2 and one multiply-add.
//  - Backward: grid (tiles, channel chunk of 16, batch).  Each thread keeps
//    the 16 channels of its pixel's gradient in registers and walks the dy
//    rows: per dy the block stages the n incoming-gradient maps of that row
//    (shifted by -d for grad_f2) and the rows of the other feature map at
//    that dy, then each dx is one read of g and 16 multiply-adds.
// Built without --fmad=false: the sums are held to the plain version by a
// tolerance, not bitwise, and keep the fused multiply-add rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define TW 32                 // tile width (a warp's row)
#define TH 8                  // tile height
#define NTHREADS (TW * TH)
#define CHUNK 16              // channels staged per step (forward), or
                              // channels of the gradient per block (backward)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Stage rows [row0, row0 + TH) x cols [col0, col0 + width) of channels
// [c0, c0 + CHUNK) of one (C, H, W) map into dst[CHUNK][TH][width], zero
// outside the map and beyond C.  Warp ty stages row ty, its lanes
// neighbouring columns (coalesced reads, no index division).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* map, int C,
                                           int H, int W, int c0, int row0,
                                           int col0, int width) {
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int y = row0 + ty;
  for (int c = 0; c < CHUNK; ++c) {
    const bool in = c0 + c < C && y >= 0 && y < H;
    const T* src = in ? map + ((size_t)(c0 + c) * H + y) * W : map;
    float* d = dst + (c * TH + ty) * width;
    for (int w = tx; w < width; w += TW) {
      const int x = col0 + w;
      d[w] = (in && x >= 0 && x < W) ? to_f(src[x]) : 0.0f;
    }
  }
}

// Forward.  NMAX >= n bounds the accumulator array at compile time.
template <typename T, int NMAX>
__global__ void __launch_bounds__(NTHREADS)
corr_forward(const T* __restrict__ f1, const T* __restrict__ f2,
             T* __restrict__ out, int C, int H, int W, int md, int s2, int n,
             int tiles_x) {
  extern __shared__ float smem[];
  const int width = TW + 2 * md;
  float* f1s = smem;                       // [CHUNK][TH][TW]
  float* f2s = smem + CHUNK * NTHREADS;    // [CHUNK][TH][width]
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int iy = blockIdx.y, b = blockIdx.z;
  const int dy = -md + iy * s2;
  const size_t plane = (size_t)H * W;
  const T* f1b = f1 + (size_t)b * C * plane;
  const T* f2b = f2 + (size_t)b * C * plane;

  float acc[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    stage_rows(f1s, f1b, C, H, W, c0, y0, x0, TW);
    stage_rows(f2s, f2b, C, H, W, c0, y0 + dy, x0 - md, width);
    __syncthreads();
    const int cn = min(CHUNK, C - c0);
    for (int c = 0; c < cn; ++c) {
      const float a = f1s[c * NTHREADS + ty * TW + tx];
      const float* row = f2s + (c * TH + ty) * width + tx;
#pragma unroll
      for (int j = 0; j < NMAX; ++j)
        if (j < n) acc[j] = fmaf(a, row[j * s2], acc[j]);
    }
    __syncthreads();
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    T* o = out + ((size_t)b * n * n + (size_t)iy * n) * plane + (size_t)y * W
           + x;
    const float fc = (float)C;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) o[(size_t)j * plane] = from_f<T>(acc[j] / fc);
  }
}

// Backward, one kernel for both gradients.  SECOND = false: grad_f1, the
// gathered map is f2 at p + d and g is read at p.  SECOND = true: grad_f2,
// the gathered map is f1 at q - d and g is read at q - d.
template <typename T, bool SECOND>
__global__ void __launch_bounds__(NTHREADS)
corr_backward(const T* __restrict__ g, const T* __restrict__ feat,
              T* __restrict__ grad, int C, int H, int W, int md, int s2,
              int n, int tiles_x) {
  extern __shared__ float smem[];
  const int width = TW + 2 * md;
  float* gs = smem;                        // [n][TH][TW]
  float* fs = smem + n * NTHREADS;         // [CHUNK][TH][width]
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int c0 = blockIdx.y * CHUNK, b = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const T* gb = g + (size_t)b * n * n * plane;
  const T* fb = feat + (size_t)b * C * plane;

  float acc[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) acc[c] = 0.0f;

  for (int iy = 0; iy < n; ++iy) {
    const int dy = -md + iy * s2;
    // the incoming gradient of this dy row at this thread's p (grad_f1)
    // or q - d (grad_f2)
    for (int j = 0; j < n; ++j) {
      const int y = y0 + ty - (SECOND ? dy : 0);
      const int x = x0 + tx - (SECOND ? -md + j * s2 : 0);
      float v = 0.0f;
      if (y >= 0 && y < H && x >= 0 && x < W)
        v = to_f(gb[(size_t)(iy * n + j) * plane + (size_t)y * W + x]);
      gs[j * NTHREADS + threadIdx.x] = v;
    }
    // the other map's rows at p + d (grad_f1) or q - d (grad_f2), cols
    // widened by md on each side
    stage_rows(fs, fb, C, H, W, c0, y0 + (SECOND ? -dy : dy), x0 - md,
               width);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float gv = gs[j * NTHREADS + ty * TW + tx];
      // window col of x0 + tx + dx_j (grad_f1) or x0 + tx - dx_j (grad_f2)
      const int col = tx + (SECOND ? (n - 1 - j) : j) * s2;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        acc[c] = fmaf(gv, fs[(c * TH + ty) * width + col], acc[c]);
    }
    __syncthreads();
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    const float fc = (float)C;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
      if (c0 + c < C)
        grad[((size_t)b * C + c0 + c) * plane + (size_t)y * W + x] =
            from_f<T>(acc[c] / fc);
  }
}

template <typename T, int NMAX>
static int launch_forward(const void* f1, const void* f2, void* out, int B,
                          int C, int H, int W, int md, int s2,
                          cudaStream_t stream) {
  const int n = 2 * (md / s2) + 1;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const size_t smem =
      sizeof(float) * CHUNK * (NTHREADS + TH * (TW + 2 * md));
  cudaError_t e = cudaFuncSetAttribute(
      corr_forward<T, NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  corr_forward<T, NMAX><<<dim3(tiles_x * tiles_y, n, B), NTHREADS, smem,
                          stream>>>(
      (const T*)f1, (const T*)f2, (T*)out, C, H, W, md, s2, n, tiles_x);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_backward(const void* g, const void* f1, const void* f2,
                           void* g1, void* g2, int B, int C, int H, int W,
                           int md, int s2, cudaStream_t stream) {
  const int n = 2 * (md / s2) + 1;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (C + CHUNK - 1) / CHUNK, B);
  const size_t smem =
      sizeof(float) * (n * NTHREADS + CHUNK * TH * (TW + 2 * md));
  cudaError_t e = cudaFuncSetAttribute(
      corr_backward<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(corr_backward<T, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  corr_backward<T, false><<<grid, NTHREADS, smem, stream>>>(
      (const T*)g, (const T*)f2, (T*)g1, C, H, W, md, s2, n, tiles_x);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  corr_backward<T, true><<<grid, NTHREADS, smem, stream>>>(
      (const T*)g, (const T*)f1, (T*)g2, C, H, W, md, s2, n, tiles_x);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  md % s2 == 0 and n = 2 md / s2 + 1 <= 41
// (the wrapper checks both); returns a cudaError_t.
extern "C" int jafpro_correlation_forward(const void* f1, const void* f2,
                                          void* out, int B, int C, int H,
                                          int W, int md, int s2, int dtype,
                                          cudaStream_t stream) {
  const int n = 2 * (md / s2) + 1;
  if (dtype == 0) {
    if (n <= 9)
      return launch_forward<float, 9>(f1, f2, out, B, C, H, W, md, s2, stream);
    if (n <= 21)
      return launch_forward<float, 21>(f1, f2, out, B, C, H, W, md, s2,
                                       stream);
    return launch_forward<float, 41>(f1, f2, out, B, C, H, W, md, s2, stream);
  }
  if (n <= 9)
    return launch_forward<__nv_bfloat16, 9>(f1, f2, out, B, C, H, W, md, s2,
                                            stream);
  if (n <= 21)
    return launch_forward<__nv_bfloat16, 21>(f1, f2, out, B, C, H, W, md, s2,
                                             stream);
  return launch_forward<__nv_bfloat16, 41>(f1, f2, out, B, C, H, W, md, s2,
                                           stream);
}

extern "C" int jafpro_correlation_backward(const void* g, const void* f1,
                                           const void* f2, void* g1,
                                           void* g2, int B, int C, int H,
                                           int W, int md, int s2, int dtype,
                                           cudaStream_t stream) {
  if (dtype == 0)
    return launch_backward<float>(g, f1, f2, g1, g2, B, C, H, W, md, s2,
                                  stream);
  return launch_backward<__nv_bfloat16>(g, f1, f2, g1, g2, B, C, H, W, md, s2,
                                        stream);
}
