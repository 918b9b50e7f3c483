// Face-index / weight-map z-buffer rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// jafpro_tpu/geometry/rasterizer_pallas.py::rasterize_fim_wim_pallas
// (kernel body _raster_kernel) and the weight recomputation and y-flip that
// follow its pallas_call.
//
// Per pixel, over all faces: back-face cull (folded into the per-face valid
// flag), three half-plane edge tests in clip coords, barycentric weights from
// the per-face inverse matrix (clamped to [0, 1]), perspective-correct 1/z,
// near/far reject, and a running (min depth, face id) with ties going to the
// lowest id.  The winner's weights are then recomputed, renormalised, written
// with the face id (-1 and zero weights for background), y-flipped.
//
// Design: one thread per pixel, one 16x16 pixel tile per CTA, one image per
// grid z.  Faces are staged through shared memory in blocks of 256 (one face
// per thread, structure-of-arrays so the stores do not conflict and the
// per-face reads are broadcasts).  A block whose front-face bounding box
// misses the tile's pixel centres is skipped with a CTA-uniform branch, as
// the Pallas kernel skips face blocks by their y-extent.  Walking faces in
// increasing id order with a strict '<' keeps the lowest id on ties.
//
// Bound: per (pixel, face) pair about 40 fp32 operations (edge tests,
// weights, three divisions and a reciprocal), so the kernel is bound by
// operations on the pairs that survive the block cull, not by bytes: it
// reads B*19*F floats and writes B*S*S*16 bytes.  Nothing here uses the
// tensor cores; speed work (warp-level culling, binning) is for later.
//
// Arithmetic follows the Pallas kernel expression for expression.  Built
// with --fmad=false and IEEE division, the face ids equal those of the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#define TILE 16
#define FACE_BLOCK 256
// per-face record, structure of arrays (B, NF, F_pad):
// x0 x1 x2 | y0 y1 y2 | z0 z1 z2 | inv[9] | valid
#define NF 19

static_assert(TILE * TILE == FACE_BLOCK, "one face per thread when staging");

// jnp.clip / torch.clamp keep NaN; fminf/fmaxf would drop it.
__device__ __forceinline__ float clamp01(float w) {
  w = (w < 0.0f) ? 0.0f : w;
  return (w > 1.0f) ? 1.0f : w;
}

__device__ __forceinline__ float clip_coord(int i, float S) {
  return (2.0f * (float)i + 1.0f - S) / S;
}

__global__ void __launch_bounds__(FACE_BLOCK)
raster_kernel(const float* __restrict__ faces,   // (B, NF, F_pad)
              const float* __restrict__ extent,  // (B, n_blocks, 4)
              int F_pad, int n_blocks, int S, float near, float far,
              int flip_y,
              int* __restrict__ fim,             // (B, S, S)
              float* __restrict__ wim) {         // (B, S, S, 3)
  __shared__ float sf[NF][FACE_BLOCK];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * TILE, row0 = blockIdx.y * TILE;
  const int col = col0 + tid % TILE, row = row0 + tid / TILE;
  const bool active = (col < S) && (row < S);
  const float Sf = (float)S;
  const float xi = (float)col, yi = (float)row;
  const float xp = (2.0f * xi + 1.0f - Sf) / Sf;
  const float yp = (2.0f * yi + 1.0f - Sf) / Sf;

  // pixel-centre extents of this tile in clip coords
  const float tx_lo = clip_coord(col0, Sf);
  const float tx_hi = clip_coord(min(col0 + TILE - 1, S - 1), Sf);
  const float ty_lo = clip_coord(row0, Sf);
  const float ty_hi = clip_coord(min(row0 + TILE - 1, S - 1), Sf);

  const float* fb = faces + (size_t)b * NF * F_pad;
  const float* eb = extent + (size_t)b * n_blocks * 4;

  float best = far;
  int best_id = -1;

  for (int blk = 0; blk < n_blocks; ++blk) {
    // block bounding box of its front faces: [ymin, ymax, xmin, xmax]
    const float bymin = eb[blk * 4 + 0], bymax = eb[blk * 4 + 1];
    const float bxmin = eb[blk * 4 + 2], bxmax = eb[blk * 4 + 3];
    if (!(bymax >= ty_lo && bymin <= ty_hi && bxmax >= tx_lo &&
          bxmin <= tx_hi))
      continue;  // uniform across the CTA

    __syncthreads();  // the previous block's reads are done
    const int f = blk * FACE_BLOCK + tid;
#pragma unroll
    for (int k = 0; k < NF; ++k) sf[k][tid] = fb[(size_t)k * F_pad + f];
    __syncthreads();

    if (!active) continue;
    for (int j = 0; j < FACE_BLOCK; ++j) {
      if (sf[18][j] == 0.0f) continue;  // back face or padding
      const float x0 = sf[0][j], x1 = sf[1][j], x2 = sf[2][j];
      const float y0 = sf[3][j], y1 = sf[4][j], y2 = sf[5][j];
      const bool e0 = (yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0);
      const bool e1 = (yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1);
      const bool e2 = (yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2);
      if (!(e0 && e1 && e2)) continue;

      float w0 = sf[9][j] * xi + sf[10][j] * yi + sf[11][j];
      float w1 = sf[12][j] * xi + sf[13][j] * yi + sf[14][j];
      float w2 = sf[15][j] * xi + sf[16][j] * yi + sf[17][j];
      w0 = clamp01(w0);
      w1 = clamp01(w1);
      w2 = clamp01(w2);
      const float ws = w0 + w1 + w2;
      const float inv_zp =
          (w0 / sf[6][j] + w1 / sf[7][j] + w2 / sf[8][j]) / ws;
      const float zp = 1.0f / inv_zp;
      const bool ok = (zp > near) && (zp < far) && (inv_zp > 0.0f);
      if (ok && zp < best) {
        best = zp;
        best_id = blk * FACE_BLOCK + j;
      }
    }
  }

  if (!active) return;
  const int out_row = flip_y ? (S - 1 - row) : row;
  const size_t o = ((size_t)b * S + out_row) * S + col;
  float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
  if (best_id >= 0) {
    const float* inv = fb + (size_t)9 * F_pad + best_id;
    w0 = inv[0] * xi + inv[(size_t)1 * F_pad] * yi + inv[(size_t)2 * F_pad];
    w1 = inv[(size_t)3 * F_pad] * xi + inv[(size_t)4 * F_pad] * yi +
         inv[(size_t)5 * F_pad];
    w2 = inv[(size_t)6 * F_pad] * xi + inv[(size_t)7 * F_pad] * yi +
         inv[(size_t)8 * F_pad];
    w0 = clamp01(w0);
    w1 = clamp01(w1);
    w2 = clamp01(w2);
    const float ws = w0 + w1 + w2;
    w0 = w0 / ws;
    w1 = w1 / ws;
    w2 = w2 / ws;
  }
  fim[o] = best_id;
  wim[o * 3 + 0] = w0;
  wim[o * 3 + 1] = w1;
  wim[o * 3 + 2] = w2;
}

extern "C" int jafpro_rasterize_fim_wim(const float* faces,
                                        const float* extent, int B,
                                        int F_pad, int n_blocks, int S,
                                        float near, float far, int flip_y,
                                        int* fim, float* wim,
                                        cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, (S + TILE - 1) / TILE, B);
  raster_kernel<<<grid, FACE_BLOCK, 0, stream>>>(
      faces, extent, F_pad, n_blocks, S, near, far, flip_y, fim, wim);
  return (int)cudaGetLastError();
}
