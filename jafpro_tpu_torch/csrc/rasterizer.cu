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
// with the face id (-1 and zero weights for background), y-flipped.  When
// the caller passes a depth map, the winner's depth (its running `best`, the
// perspective-correct zp) is written too, 0 at background: the XLA
// rasterizer's return_depth contract (the Pallas kernel's depth_ref output).
//
// Bound: the bytes.  An exact z-buffer must read B*F triangles and write
// B*S*S face ids and weights; the pairs it must test (pixel centres inside a
// front face's bounding box) are few, about 1.2e6 on a 30-pose, 13776-face
// 256x256 clip, so the bytes set the least time (0.0138 ms on an H100; 0.0162
// ms with the depth map, 4 more bytes per pixel).  What
// costs time in practice is the pairs actually tested and the shared-memory
// traffic and barriers spent to find them.
//
// Design: one thread per pixel, one 16x16 pixel tile per CTA, one image per
// grid z.  Faces come in blocks of 256 (the record layout of prepare_faces,
// structure of arrays (B, NF, F_pad)).  Per tile:
//  1. A CTA-uniform skip of every block whose cull box (`extent`) holds no
//     pixel centre of the tile; each warp scans 32 block boxes at a time
//     with one ballot.  prepare_faces makes a block's box hold the widened
//     box of each of its front faces (step 2), so the skip drops no face
//     that step 2 would keep.
//  2. For a block that passes, thread t culls face blk*256+t on its own: it
//     keeps the face if it is valid and its xy box, widened by one pixel
//     (2/S) and by the distance beyond it at which its float edge tests
//     could accept a point (keep_face below), holds a pixel centre of the
//     tile.  Only the 7 floats the cull needs (x0..2, y0..2, valid) are
//     read, and the next passing block's are staged with cp.async into the
//     other half of a double buffer while this block is culled and tested.
//  3. Survivors are compacted in face-id order (ballot + popc inside a warp,
//     warp counts through shared memory) into a structure-of-arrays list in
//     shared memory with their face ids; the 12 floats the cull did not read
//     (z, inverse matrix) are gathered from global memory for survivors
//     only, issued before the compaction's barrier so that they overlap it.
//  4. Every pixel walks the list in increasing face id with a strict '<', so
//     ties keep the lowest id, as in the Pallas kernel and the plain version.
// On a mesh whose faces come in arbitrary order every block's box covers the
// body, so step 1 alone skips little; step 2 does not depend on face order.
//
// No tensor cores: the per-pair work is compares and IEEE divisions, and
// TF32 would break the bitwise agreement with the plain version.
//
// Arithmetic follows the Pallas kernel expression for expression.  Built
// with --fmad=false and IEEE division, the face ids equal those of the
// plain PyTorch version bit for bit; the culls only remove pairs whose edge
// tests fail in float (see keep_face), and face_tile_keep in
// geometry/rasterizer.py is their plain form.

#include <cuda_runtime.h>

#define TILE 16
#define FACE_BLOCK 256
// per-face record, structure of arrays (B, NF, F_pad):
// x0 x1 x2 | y0 y1 y2 | z0 z1 z2 | inv[9] | valid
#define NF 19
#define NCULL 7      // x0..2, y0..2, valid: the floats the cull reads
#define NLIST 18     // x, y, z, inv of a survivor (valid is implied)
#define NWARP (FACE_BLOCK / 32)
// the per-face cull's reach factor, 2^-18 = 32 float32 epsilons (keep_face)
#define REACH 3.814697265625e-06f

static_assert(TILE * TILE == FACE_BLOCK, "one face per thread when culling");

// jnp.clip / torch.clamp keep NaN; fminf/fmaxf would drop it.
__device__ __forceinline__ float clamp01(float w) {
  w = (w < 0.0f) ? 0.0f : w;
  return (w > 1.0f) ? 1.0f : w;
}

__device__ __forceinline__ float clip_coord(int i, float S) {
  return (2.0f * (float)i + 1.0f - S) / S;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct TileBox {
  float x_lo, x_hi, y_lo, y_hi;  // pixel-centre extents in clip coords
};

// First block at or after `from` whose cull box [ymin, ymax, xmin, xmax]
// holds a pixel centre of the tile, or n_blocks.  Every warp computes
// the same answer, so the result is uniform across the CTA.
__device__ __forceinline__ int next_block(const float4* __restrict__ ext,
                                          int from, int n_blocks,
                                          const TileBox& t) {
  const int lane = threadIdx.x & 31;
  for (int base = from; base < n_blocks; base += 32) {
    const int blk = base + lane;
    bool hit = false;
    if (blk < n_blocks) {
      const float4 e = ext[blk];
      hit = e.y >= t.y_lo && e.x <= t.y_hi && e.w >= t.x_lo && e.z <= t.x_hi;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m) return base + __ffs(m) - 1;
  }
  return n_blocks;
}

// Stage the cull floats of face blk*256+threadIdx.x (own column only).
__device__ __forceinline__ void stage_cull(float (*dst)[FACE_BLOCK],
                                           const float* fb, int F_pad,
                                           int blk) {
  const int t = threadIdx.x;
  const size_t f = (size_t)blk * FACE_BLOCK + t;
#pragma unroll
  for (int k = 0; k < 6; ++k) cp_async4(&dst[k][t], fb + k * (size_t)F_pad + f);
  cp_async4(&dst[6][t], fb + 18 * (size_t)F_pad + f);
  cp_async_commit();
}

// Does a face with these cull floats need testing in this tile?  A valid
// face is kept if its box, widened by m = 2/S plus its reach r, holds a
// pixel centre of the tile.  The float edge tests accept a point outside
// the exact triangle by at most 2*err*W / (2A) beyond its box (err: their
// rounding error, about 6 eps (1 + M) W; 2A = |a - b|, the doubled area),
// and r = REACH (1 + M) W^2 / (2A) is 8/3 of that.  A face with r > 4 or a
// NaN r (zero area: the edge tests accept all along its line) is kept in
// every tile.  Valid faces have no NaN coordinate (the front test is false
// then), so fminf/fmaxf equal torch's min/max here.  face_cull_box in
// geometry/rasterizer.py is the same test; prepare_faces builds the block
// boxes of step 1 from it.
__device__ __forceinline__ bool keep_face(float x0, float x1, float x2,
                                          float y0, float y1, float y2,
                                          float valid, float m,
                                          const TileBox& t) {
  const float xmin = fminf(fminf(x0, x1), x2), xmax = fmaxf(fmaxf(x0, x1), x2);
  const float ymin = fminf(fminf(y0, y1), y2), ymax = fmaxf(fmaxf(y0, y1), y2);
  const float a = (y2 - y0) * (x1 - x0);
  const float b = (y1 - y0) * (x2 - x0);
  const float M = fmaxf(fmaxf(fabsf(xmin), fabsf(xmax)),
                        fmaxf(fabsf(ymin), fabsf(ymax)));
  const float W = fmaxf(xmax - xmin, ymax - ymin);
  const float r = REACH * (1.0f + M) * W * W / fabsf(a - b);
  const float w = (r <= 4.0f) ? m + r : __int_as_float(0x7f800000);  // +inf
  const bool hit = (xmax + w >= t.x_lo) && (xmin - w <= t.x_hi) &&
                   (ymax + w >= t.y_lo) && (ymin - w <= t.y_hi);
  return (valid > 0.0f) && hit;
}

__global__ void __launch_bounds__(FACE_BLOCK)
raster_kernel(const float* __restrict__ faces,   // (B, NF, F_pad)
              const float* __restrict__ extent,  // (B, n_blocks, 4)
              int F_pad, int n_blocks, int S, float near, float far,
              int flip_y,
              int* __restrict__ fim,             // (B, S, S)
              float* __restrict__ wim,           // (B, S, S, 3)
              float* __restrict__ dim) {         // (B, S, S) or null
  __shared__ float cull[2][NCULL][FACE_BLOCK];  // cp.async double buffer
  __shared__ float lst[NLIST][FACE_BLOCK];      // survivors, face-id order
  __shared__ int lst_id[FACE_BLOCK];
  __shared__ int warp_cnt[2][NWARP];            // by block parity

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * TILE, row0 = blockIdx.y * TILE;
  const int col = col0 + tid % TILE, row = row0 + tid / TILE;
  const bool active = (col < S) && (row < S);
  const float Sf = (float)S;
  const float xi = (float)col, yi = (float)row;
  const float xp = (2.0f * xi + 1.0f - Sf) / Sf;
  const float yp = (2.0f * yi + 1.0f - Sf) / Sf;
  const float m = 2.0f / Sf;  // one pixel in clip coords

  TileBox tb;
  tb.x_lo = clip_coord(col0, Sf);
  tb.x_hi = clip_coord(min(col0 + TILE - 1, S - 1), Sf);
  tb.y_lo = clip_coord(row0, Sf);
  tb.y_hi = clip_coord(min(row0 + TILE - 1, S - 1), Sf);

  const float* fb = faces + (size_t)b * NF * F_pad;
  const float4* eb =
      reinterpret_cast<const float4*>(extent + (size_t)b * n_blocks * 4);

  float best = far;
  int best_id = -1;

  int blk = next_block(eb, 0, n_blocks, tb);
  if (blk < n_blocks) stage_cull(cull[0], fb, F_pad, blk);
  for (int it = 0; blk < n_blocks; ++it) {
    const int buf = it & 1;
    const int nxt = next_block(eb, blk + 1, n_blocks, tb);
    if (nxt < n_blocks) {
      stage_cull(cull[buf ^ 1], fb, F_pad, nxt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }

    // 2. per-face cull on this thread's own staged column
    float(*cb)[FACE_BLOCK] = cull[buf];
    const float x0 = cb[0][tid], x1 = cb[1][tid], x2 = cb[2][tid];
    const float y0 = cb[3][tid], y1 = cb[4][tid], y2 = cb[5][tid];
    const bool keep =
        keep_face(x0, x1, x2, y0, y1, y2, cb[6][tid], m, tb);

    // the rest of a survivor's record, loaded before the barrier so that
    // the loads overlap it
    const int f = blk * FACE_BLOCK + tid;
    float rest[NLIST - 6];
    if (keep) {
#pragma unroll
      for (int k = 6; k < NLIST; ++k)
        rest[k - 6] = fb[(size_t)k * F_pad + f];
    }

    // 3. compaction in face-id order
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_cnt[it & 1][warp] = __popc(ballot);
    // all threads are past the previous block's list reads and offsets
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const int c = warp_cnt[it & 1][w];
      offset += (w < warp) ? c : 0;
      total += c;
    }
    if (total == 0) {  // uniform across the CTA
      blk = nxt;
      continue;
    }
    if (keep) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      lst[0][pos] = x0;
      lst[1][pos] = x1;
      lst[2][pos] = x2;
      lst[3][pos] = y0;
      lst[4][pos] = y1;
      lst[5][pos] = y2;
#pragma unroll
      for (int k = 6; k < NLIST; ++k) lst[k][pos] = rest[k - 6];
      lst_id[pos] = f;
    }
    __syncthreads();

    // 4. every pixel against the survivors, in face-id order
    if (active) {
      for (int j = 0; j < total; ++j) {
        const float fx0 = lst[0][j], fx1 = lst[1][j], fx2 = lst[2][j];
        const float fy0 = lst[3][j], fy1 = lst[4][j], fy2 = lst[5][j];
        const bool e0 = (yp - fy0) * (fx1 - fx0) >= (xp - fx0) * (fy1 - fy0);
        const bool e1 = (yp - fy1) * (fx2 - fx1) >= (xp - fx1) * (fy2 - fy1);
        const bool e2 = (yp - fy2) * (fx0 - fx2) >= (xp - fx2) * (fy0 - fy2);
        if (!(e0 && e1 && e2)) continue;

        float w0 = lst[9][j] * xi + lst[10][j] * yi + lst[11][j];
        float w1 = lst[12][j] * xi + lst[13][j] * yi + lst[14][j];
        float w2 = lst[15][j] * xi + lst[16][j] * yi + lst[17][j];
        w0 = clamp01(w0);
        w1 = clamp01(w1);
        w2 = clamp01(w2);
        const float ws = w0 + w1 + w2;
        const float inv_zp =
            (w0 / lst[6][j] + w1 / lst[7][j] + w2 / lst[8][j]) / ws;
        const float zp = 1.0f / inv_zp;
        const bool ok = (zp > near) && (zp < far) && (inv_zp > 0.0f);
        if (ok && zp < best) {
          best = zp;
          best_id = lst_id[j];
        }
      }
    }
    blk = nxt;
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
  if (dim != nullptr) dim[o] = (best_id >= 0) ? best : 0.0f;
}

extern "C" int jafpro_rasterize_fim_wim(const float* faces,
                                        const float* extent, int B,
                                        int F_pad, int n_blocks, int S,
                                        float near, float far, int flip_y,
                                        int* fim, float* wim, float* dim,
                                        cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, (S + TILE - 1) / TILE, B);
  raster_kernel<<<grid, FACE_BLOCK, 0, stream>>>(
      faces, extent, F_pad, n_blocks, S, near, far, flip_y, fim, wim, dim);
  return (int)cudaGetLastError();
}
