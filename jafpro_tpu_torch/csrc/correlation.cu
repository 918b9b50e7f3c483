// FlowNetC cost-volume correlation for Hopper (sm_90a), forward and backward,
// as banded row-pair products on the tensor cores.
//
// Replaces jafpro_tpu/ops/correlation.py::correlation (the JAX package's
// lax.scan over displacements, its "TPU-native equivalent of the reference's
// correlation_cuda") and, for the backward, XLA's autodiff of that scan.
//
//   out    [b, k, p] = (1/C) sum_c f1[b, c, p] * f2[b, c, p + d_k]
//   grad_f1[b, c, p] = (1/C) sum_k g[b, k, p] * f2[b, c, p + d_k]
//   grad_f2[b, c, q] = (1/C) sum_k g[b, k, q - d_k] * f1[b, c, q - d_k]
//
// with f2 (and f1, g at q - d) zero outside the image, displacements dy, dx
// in {-md, -md + s2, ..., md} (n = 2 md / s2 + 1 of each) and k = iy * n + jx,
// dy-major: the reference CUDA layout.  Tensors are NCHW, contiguous, float32
// or bfloat16; every sum is taken in float32 and the result is written in the
// input's type (as jnp.mean of a bf16 product returns bf16).  Both gradients
// are gathers: no atomics, a deterministic result.
//
// Bound: the operations.  At FlowNetC's training shape (B 8, C 256, 32 x 32,
// md 20, s2 2, D 441) the forward is 2 B C H W D = 1.85 GFLOP against 16.8 MB
// of inputs and 14.5 MB of output, the backward twice the operations: 0.028
// and 0.055 ms on the CUDA cores' float32 rate (67 TFLOP/s); the bytes take
// 0.009 and 0.014 ms at 3.35 TB/s.  On the tensor cores 3xTF32 (three TF32
// products per multiply-add) needs 5.5 GFLOP forward, 0.011 ms at 495
// TFLOP/s; the banded tiles below compute 40 columns for 21 (1.9x).
//
// Design.  For a batch b, output row y, displacement row dy and parity class
// pi (the pixels x = pi (mod s2)), each of the three sums is a dense product
// of one row pair:
//   A  = f1[b, :, y, x = pi] as 16 pixels m x C channels,
//   Bt = f2[b, :, y + dy, .] on the same class's columns t = 0 .. NC - 1,
//        x' = X0 + pi + s2 (t - md / s2), zero outside the image (C x NC,
//        NC = 8 NT >= 16 + n - 1),
//   P  = A Bt, and out[b, iy n + j, y, x_m] = P[m, m + j] / C.
// The backward takes the same products the other way round:
//   grad_f1 row = sum_dy G Bt^T, G[m, t] = g[iy n + t - m, y, x_m] on the band
//   0 <= t - m < n and zero elsewhere;
//   grad_f2 row = sum_dy G' A'^T over the f1 rows y - dy, with A' staged as Bt
//   is and G'[m, t] = g[iy n + (n - 1) - (t - m), y - dy, x'_t].
// A block takes one (b, y, tile of 16 s2 pixels): all s2 classes, so the f2
// row it stages serves every class (a block per class would fetch each
// 32-byte sector of that row s2 times).  Its s2 x wpc warps (wpc = 8 / s2)
// each own one class.  The products run on mma.sync: float32 as 3xTF32
// (x = hi + lo, hi rounded to TF32; a_lo b_hi + a_hi b_lo + a_hi b_hi,
// float32 accumulators), bfloat16 as m16n8k16 with float32 accumulators
// (the products are exact, so the sums are the plain form's float32 sums).
// Never 1xTF32: its 1e-4 error breaks the 1e-5 tolerances.
//  - Forward: A stays in shared memory for all dy when f1's row fits
//    (float32 C up to 1024 at md 20, s2 2, 1984 at md 4, s2 1; twice that
//    in bfloat16);
//    past that each chunk of A rides the ring with its f2 chunk, restaged
//    for every dy row, so any C is taken.  The block walks the
//    (dy row, chunk of 8 wpc channel words) steps through a ring of STAGES
//    slots, staged STAGES - 1 steps ahead with cp.async; each warp takes one
//    k-step (8 channels float32, 16 bfloat16) of its class per step, so the
//    channels are split over the class's warps, whose partial P tiles are
//    summed in a fixed order when the band is read out of shared memory and
//    written as coalesced rows of out (during the next dy row's products).
//  - Backward (one kernel per gradient): per dy the block stages G (the band
//    of g, read once per block and dy) and streams the other map's row in
//    chunks of 16 wpc channels through the same kind of ring; each warp
//    keeps G's fragments in registers for the dy and takes two 8-channel
//    tiles of each chunk, accumulating over every dy in registers (up to 4
//    chunks, 256 channels at s2 2; a grid dimension takes further groups).
//  - Rows y + dy (or y - dy) outside the image are skipped: they contribute
//    zero (the forward writes their zeros directly).
//  - Staging: float32 rows are copied as they lie in memory (class pi's
//    column t at pi + s2 t), only the columns inside the image and the band,
//    by 16-byte cp.async where rows and tile edges are 16-byte aligned (4
//    bytes otherwise), several short rows per warp instruction; the ring
//    starts zeroed, so the padding is never copied.  bfloat16 words pair two
//    2-byte elements (of two channels, or two band columns), so bfloat16 is
//    staged by plain loads and 16-bit stores, de-interleaved by class.
//  - Each pass of products runs over all tiles before the next, so
//    consecutive mma.sync are independent (one tile's three products back
//    to back wait on each other).
// What this does about the first design (a thread per pixel, a shared
// f2 read per multiply-add; times at FlowNetC's shape, float32, NVIDIA H100
// 80GB HBM3 at 700 W, in turns in one run, PERF.md): forward 0.139 ms and
// backward 0.230 ms against 0.564 and 1.387 ms:
//  1. One shared-memory read per multiply-add: a 32-bit fragment read now
//     feeds 8 (B) or 16 (A) multiply-adds of an m16n8 tile, on the tensor
//     cores.
//  2. Re-reads and barriers: A (f1's row) is staged once per block and G once
//     per block and dy, reused across all dy (all channels); g is read once
//     per block and dy, not once per 16-channel block; one barrier per chunk
//     of 32 (forward) or 64 (backward) channels at s2 2.
//  3. Grid: 256 blocks at FlowNetC's shape, 104 KB (forward) and 110 KB
//     (backward) of shared memory and at most 128 registers, two per SM:
//     one wave on 132 SMs.
// What bounds it now is instructions, not bytes or the tensor cores: per
// step a forward block spends about as long starting its copies as on its
// products and on writing the previous band (clock64 on the card).  Built
// without --fmad=false: the sums are held to the plain version by a
// tolerance.  jafpro_correlation_plan returns the launch (grid, threads,
// shared memory) that ops/correlation.py::launch_plan mirrors.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SMEM_LIMIT 232448   // shared memory one block may use on Hopper
#define COL_SLOTS 8         // a lane stages columns lane + 32 i, i < 8
#define PIX_SLOTS 4         // and pixels lane + 32 i of a tile, i < 4
#define CHUNKS_MAX 4        // backward channel chunks per block
#define STAGES 4            // ring slots: chunks staged 3 steps ahead

namespace {

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// float32: copy 4 floats (vec) or 1 into shared memory by cp.async, or
// zero them.
__device__ __forceinline__ void put_f(uint32_t* dst, const float* src,
                                      bool vec = false) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void zero_f(uint32_t* dst, bool vec) {
  if (vec)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else
    *dst = 0u;
}
// bfloat16: the 16-bit half idx of base's words gets src's value (a load
// and a 16-bit store), or zero.
__device__ __forceinline__ void put_h(uint32_t* base, int idx,
                                      const __nv_bfloat16* src) {
  reinterpret_cast<unsigned short*>(base)[idx] =
      src ? __ldg(reinterpret_cast<const unsigned short*>(src))
          : (unsigned short)0;
}
// one element at T-unit index idx (a word for float32, a half for
// bfloat16)
__device__ __forceinline__ void put(uint32_t* base, int idx,
                                    const float* src) {
  put_f(base + idx, src);
}
__device__ __forceinline__ void put(uint32_t* base, int idx,
                                    const __nv_bfloat16* src) {
  put_h(base, idx, src);
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10-bit mantissa, to nearest, ties
// away, as cvt.rna.tf32.f32 but in two integer operations), lo = x - hi
// exactly; the tensor cores read lo's top 10 mantissa bits (a residual of
// at most 2^-11 |x|, so lo's truncation costs under 2^-21 |x|).
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi,
                                      uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// d += A B on one m16n8 tile: TF32 m16n8k8 or bf16 m16n8k16, float32
// accumulators.  Not volatile, so the compiler may interleave the products
// of independent tiles.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment words -> (hi, lo) for float32 (3xTF32); bfloat16 keeps the words
// in hi and multiplies once.
template <typename T, int N>
__device__ __forceinline__ void split_frag(const uint32_t* w, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (sizeof(T) == 4) {
      split(w[i], hi[i], lo[i]);
    } else {
      hi[i] = w[i];
      lo[i] = 0;
    }
  }
}
// d += a_hi b_hi: the one product of bfloat16, the big one of 3xTF32.
template <typename T>
__device__ __forceinline__ void mma_big(float* d, const uint32_t* ah,
                                        const uint32_t* bh) {
  if (sizeof(T) == 4)
    mma_tf32(d, ah, bh);
  else
    mma_bf16(d, ah, bh);
}

// ---- the launch plan (jafpro_correlation_plan; ops/correlation.py) ----

struct Plan {
  int n, nt, s2, wpc, nw, tiles_x;
  int nq, a_ring, fwd_smem;  // forward: channel-word chunks, f1's row
                             // streamed (1) or resident (0), shared bytes
  int groups, bwd_smem;  // backward: channel groups, shared bytes
};

// 0, or a cudaError_t for a shape the kernels do not take.
int make_plan(int B, int C, int H, int W, int md, int s2, int dtype,
              Plan* p) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || s2 < 1 || md < 0 || md % s2 ||
      s2 > 8 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool f32 = dtype == 0;
  p->n = 2 * (md / s2) + 1;
  const int need = 15 + p->n;  // band columns of a 16-pixel class tile
  p->nt = need <= 24 ? 3 : need <= 40 ? 5 : need <= 56 ? 7 : 0;
  if (!p->nt) return (int)cudaErrorInvalidValue;
  const int nc = 8 * p->nt;
  p->s2 = s2;
  p->wpc = 8 / s2 > 1 ? 8 / s2 : 1;
  p->nw = s2 * p->wpc;
  const int xt = 16 * s2;
  p->tiles_x = (W + xt - 1) / xt;
  // forward: chunks of kc channel words (a word: 1 float32 or 2 bfloat16)
  const int cw = f32 ? C : (C + 1) / 2, kc = 8 * p->wpc;
  p->nq = (cw + kc - 1) / kc;
  const int bw = s2 * nc;
  const int sb = bw + (bw % 16 ? 0 : 8), ncp = nc + (nc % 16 ? 0 : 8);
  const long rest = (long)STAGES * kc * sb + (long)s2 * p->wpc * 16 * ncp;
  // f1's row stays resident when it fits; else its chunks ride the ring
  p->a_ring = 4 * ((long)p->nq * kc * (xt + 8) + rest) > SMEM_LIMIT;
  const long fwd =
      (long)(p->a_ring ? STAGES : p->nq) * kc * (xt + 8) + rest;
  // backward: K runs over the band columns t (pairs of t for bfloat16)
  const int nck = f32 ? nc : (nc + 15) / 16 * 16;
  const int sg = (f32 ? nck : nck / 2) + 4, cc = 16 * p->wpc;
  p->groups = (C + CHUNKS_MAX * cc - 1) / (CHUNKS_MAX * cc);
  const long bwd = (long)STAGES * s2 * (16 + cc) * sg;
  if (bw > 32 * COL_SLOTS || s2 * nck > 32 * COL_SLOTS ||
      xt > 32 * PIX_SLOTS)
    return (int)cudaErrorInvalidValue;
  if (4 * fwd > SMEM_LIMIT || 4 * bwd > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  p->fwd_smem = (int)(4 * fwd);
  p->bwd_smem = (int)(4 * bwd);
  return 0;
}

// valid displacement rows: 0 <= y + sign * dy < H, dy = -md + iy s2
__device__ __forceinline__ void dy_range(int y, int H, int md, int s2, int n,
                                         bool minus, int& lo, int& hi) {
  if (!minus) {  // y + dy in [0, H)
    lo = md - y > 0 ? (md - y + s2 - 1) / s2 : 0;
    hi = min(n - 1, (H - 1 - y + md) / s2);
  } else {  // y - dy in [0, H)
    const int e = y - H + 1 + md;
    lo = e > 0 ? (e + s2 - 1) / s2 : 0;
    hi = min(n - 1, (y + md) / s2);
  }
}

// float32 rows are staged as they lie in memory: col = x - X0 + md for
// col in [0, span), class pi's column t at col pi + s2 t.  Only the columns
// inside the image and the band (t < 15 + n) are copied: units [u_lo,
// u_hi) of 4 floats when rows and tile edges are 16-byte aligned, else of
// 1 float; the rest stays zero.  A warp copies rpw = 32 / lr rows at once,
// lr lanes a row.
struct RowCopy {
  bool vec;
  int unit, u_lo, u_hi, lr, rpw;
};
__device__ __forceinline__ RowCopy row_copy(int X0, int W, int md, int s2,
                                            int n, int span,
                                            const void* base) {
  RowCopy rc;
  rc.vec = W % 4 == 0 && md % 4 == 0 && ((size_t)base & 15) == 0;
  rc.unit = rc.vec ? 4 : 1;
  const int lo = max(0, md - X0);                       // x >= 0
  const int hi = min(min(W - X0 + md, s2 * (15 + n)), span);
  rc.u_lo = lo / rc.unit;
  rc.u_hi = (hi + rc.unit - 1) / rc.unit;
  const int nu = rc.u_hi - rc.u_lo;
  rc.lr = nu <= 8 ? 8 : nu <= 16 ? 16 : 32;
  rc.rpw = 32 / rc.lr;
  return rc;
}

// ---------------------------------------------------------------- forward

// RING: f1's row rides the ring chunk by chunk (it does not fit whole)
template <typename T, int NT, bool RING>
__global__ void __launch_bounds__(256, 2)
corr_forward(const T* __restrict__ f1, const T* __restrict__ f2,
             T* __restrict__ out, int C, int H, int W, int md, int s2, int n,
             int wpc, int nq) {
  constexpr int NC = 8 * NT;
  constexpr int MUL = sizeof(T) == 4 ? 1 : 2;  // T units per word
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int xt = 16 * s2, X0 = blockIdx.x * xt, y = blockIdx.y;
  const int b = blockIdx.z;
  const int kc = 8 * wpc, sa = xt + 8, bw = s2 * NC;
  const int sb = bw + (bw % 16 ? 0 : 8);
  constexpr int NCP = NC + (NC % 16 ? 0 : 8);
  const int na = (RING ? STAGES : nq) * kc * sa;
  uint32_t* As = smem;  // [nq kc][sa]: f1's row, or [STAGES][kc][sa]: chunks
  uint32_t* Bs = As + na;                  // [STAGES][kc][sb]: f2 chunks
  float* Ps = reinterpret_cast<float*>(Bs + STAGES * kc * sb);
  // Ps: [s2][wpc][16][NCP], each warp's partial P tile of a dy row
  const size_t plane = (size_t)H * W;
  const T* f1b = f1 + (size_t)b * C * plane + (size_t)y * W;
  const T* f2b = f2 + (size_t)b * C * plane;
  const int pi = warp / wpc, wc = warp % wpc;  // this warp's class, k share
  const float fc = (float)C;

  // float32: f2's rows as they lie (row_copy); bfloat16: this lane's
  // columns of a staged row, col = lane + 32 i -> (class, t) = (col % s2,
  // col / s2) at x = X0 - md + col, packed in channel pairs; copied only
  // inside the image and the band (t < 15 + n), zero elsewhere
  const RowCopy rc = row_copy(X0, W, md, s2, n, bw, f2);
  int bcol[COL_SLOTS];
  unsigned bok = 0;
#pragma unroll
  for (int i = 0; i < COL_SLOTS; ++i) {
    const int col = lane + 32 * i;
    const int t = col / s2, x = X0 - md + col;
    bcol[i] = MUL * ((col % s2) * NC + t);
    if (col < bw && x >= 0 && x < W && t < 15 + n) bok |= 1u << i;
  }
  // this lane's pixels of the tile: xl = lane + 32 i -> (class, m)
  int pcl[PIX_SLOTS], pm[PIX_SLOTS];
  unsigned pok = 0;
#pragma unroll
  for (int i = 0; i < PIX_SLOTS; ++i) {
    const int xl = lane + 32 * i;
    pcl[i] = xl % s2;
    pm[i] = xl / s2;
    if (xl < xt && X0 + xl < W) pok |= 1u << i;
  }

  int lo, hi;
  dy_range(y, H, md, s2, n, false, lo, hi);

  // zeros for the dy rows that fall outside the image
  for (int iy = 0; iy < n; ++iy) {
    if (iy == lo) iy = hi + 1;
    if (iy >= n) break;
    for (int j = warp; j < n; j += nw) {
      T* o = out + (((size_t)b * n * n + (size_t)iy * n + j) * H + y) * W + X0;
#pragma unroll
      for (int i = 0; i < PIX_SLOTS; ++i)
        if (pok >> i & 1) o[lane + 32 * i] = from_f<T>(0.0f);
    }
  }

  // A and the ring start at zero: what no copy writes stays zero
  for (int i = threadIdx.x; i < na + STAGES * kc * sb; i += blockDim.x)
    smem[i] = 0u;
  __syncthreads();

  // f1's channels c0 .. c0 + cn - 1 into dst: word row r holds channel
  // c0 + r (float32) or channels c0 + 2r, c0 + 2r + 1 (bfloat16); channels
  // from C on are written as zeros (a ring slot holds an earlier chunk)
  auto stage_a = [&](uint32_t* dst, int c0, int cn) {
    for (int r = warp; r < cn; r += nw) {
      const int c = c0 + r;
      const T* src = f1b + (size_t)(c < C ? c : 0) * plane + X0;
      const int rowpart = MUL == 1 ? r * sa : (r >> 1) * 2 * sa + (r & 1);
#pragma unroll
      for (int i = 0; i < PIX_SLOTS; ++i) {
        if (!(pok >> i & 1)) continue;
        const int at = rowpart + MUL * (pcl[i] * 16 + pm[i]);
        if (c < C)
          put(dst, at, src + lane + 32 * i);
        else if constexpr (MUL == 1)
          dst[at] = 0u;
        else
          put_h(dst, at, nullptr);
      }
    }
  };
  // f1's row, all channels, when it stays resident
  if (!RING) stage_a(As, 0, C);

  // stage chunk q of f2's row y + dy_iy into ring slot buf (and chunk q of
  // f1's row when it rides the ring)
  auto stage_b = [&](int buf, int iy, int q) {
    if (RING) stage_a(As + buf * kc * sa, MUL * q * kc, MUL * kc);
    const int yy = y - md + iy * s2;
    uint32_t* dst = Bs + buf * kc * sb;
    if constexpr (MUL == 1) {
      for (int r = warp * rc.rpw + lane / rc.lr; r < kc; r += nw * rc.rpw) {
        const int c = q * kc + r;
        const T* src =
            f2b + ((size_t)(c < C ? c : 0) * H + yy) * W + X0 - md;
        uint32_t* d = dst + r * sb;
        for (int u = rc.u_lo + lane % rc.lr; u < rc.u_hi; u += rc.lr) {
          if (c < C)
            put_f(d + u * rc.unit, src + u * rc.unit, rc.vec);
          else
            zero_f(d + u * rc.unit, rc.vec);
        }
      }
    } else {  // channel pairs: word row r >> 1, half r & 1
      for (int r = warp; r < 2 * kc; r += nw) {
        const int c = 2 * q * kc + r;
        const T* src =
            f2b + ((size_t)(c < C ? c : 0) * H + yy) * W + X0 - md;
        const int rowpart = (r >> 1) * 2 * sb + (r & 1);
#pragma unroll
        for (int i = 0; i < COL_SLOTS; ++i)
          if (bok >> i & 1)
            put_h(dst, rowpart + bcol[i],
                  c < C ? src + lane + 32 * i : nullptr);
      }
    }
  };
  // the band of dy row iy: P[m, m + j], summed over the class's warps
  auto band_out = [&](int iy) {
    for (int j = warp; j < n; j += nw) {
      T* o = out + (((size_t)b * n * n + (size_t)iy * n + j) * H + y) * W + X0;
#pragma unroll
      for (int i = 0; i < PIX_SLOTS; ++i) {
        if (!(pok >> i & 1)) continue;
        const float* P = Ps + (pcl[i] * wpc * 16 + pm[i]) * NCP + pm[i] + j;
        float v = 0.0f;
        for (int w = 0; w < wpc; ++w) v += P[w * 16 * NCP];
        o[lane + 32 * i] = from_f<T>(v / fc);
      }
    }
  };

  // the ring: step s = (dy row, chunk) is staged STAGES - 1 steps ahead,
  // one copy group per step (A rides with the first)
  const int nsteps = (hi - lo + 1) * nq;
  int iy_s = lo, q_s = 0;
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nsteps) {
      stage_b(k, iy_s, q_s);
      if (++q_s == nq) q_s = 0, ++iy_s;
    }
    cp_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  int iy = lo, q = 0, done = -1;  // done: a dy row whose P tiles are in Ps
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nsteps) {
      stage_b((s + STAGES - 1) % STAGES, iy_s, q_s);
      if (++q_s == nq) q_s = 0, ++iy_s;
    }
    cp_commit();

    // this warp's k-step of the chunk (words 8 wc .. 8 wc + 7), every tile
    {
      const uint32_t* Ap = As + ((RING ? s % STAGES : q) * kc + 8 * wc) *
                                   sa + pi * 16;
      const uint32_t aw[4] = {Ap[tg * sa + gq], Ap[tg * sa + gq + 8],
                              Ap[(tg + 4) * sa + gq],
                              Ap[(tg + 4) * sa + gq + 8]};
      uint32_t ah[4], al[4];
      split_frag<T, 4>(aw, ah, al);
      // column of (class pi, t = 8 tile + gq): pi + s2 t (float32) or
      // pi NC + t (bfloat16)
      const uint32_t* Bp = Bs + (s % STAGES) * kc * sb + 8 * wc * sb +
                           (MUL == 1 ? pi + s2 * gq : pi * NC + gq);
      const int tstep = MUL == 1 ? 8 * s2 : 8;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint32_t bw2[2] = {Bp[tg * sb + tstep * t],
                                 Bp[(tg + 4) * sb + tstep * t]};
        split_frag<T, 2>(bw2, bh[t], bl[t]);
      }
      // tile-inner passes (a_lo b_hi, a_hi b_lo, a_hi b_hi): consecutive
      // products are independent
      if (sizeof(T) == 4) {
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_tf32(acc[t], al, bh[t]);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_tf32(acc[t], ah, bl[t]);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) mma_big<T>(acc[t], ah, bh[t]);
    }
    // the previous dy row's band goes out while the products run
    if (done >= 0) {
      band_out(done);
      done = -1;
    }
    if (q == nq - 1) {  // this warp's partial P tile of the dy row
      if (nq == 1) __syncthreads();  // every warp has read Ps
      float* P = Ps + (pi * wpc + wc) * 16 * NCP;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        *reinterpret_cast<float2*>(P + gq * NCP + 8 * t + 2 * tg) =
            make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(P + (gq + 8) * NCP + 8 * t + 2 * tg) =
            make_float2(acc[t][2], acc[t][3]);
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
      }
      done = iy;
    }
    if (++q == nq) q = 0, ++iy;
  }
  __syncthreads();
  band_out(done);
}

// --------------------------------------------------------------- backward

// SECOND = false: grad_f1, feat = f2 at rows y + dy, G from g's row y.
// SECOND = true:  grad_f2, feat = f1 at rows y - dy, G from g's rows y - dy.
template <typename T, int NT, bool SECOND>
__global__ void __launch_bounds__(256, 2)
corr_backward(const T* __restrict__ g, const T* __restrict__ feat,
              T* __restrict__ grad, int C, int H, int W, int md, int s2,
              int n, int wpc, int groups) {
  constexpr int MUL = sizeof(T) == 4 ? 1 : 2;
  constexpr int NCK = MUL == 1 ? 8 * NT : (8 * NT + 15) / 16 * 16;
  constexpr int KS = NCK / MUL / 8;    // k-steps of 8 words over t
  constexpr int SG = NCK / MUL + 4;    // word stride of G (and bf16 rows)
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int xt = 16 * s2, X0 = blockIdx.x * xt, y = blockIdx.y;
  const int b = blockIdx.z / groups, cg = blockIdx.z % groups;
  const int cc = 16 * wpc, span = s2 * NCK;
  const int c0 = cg * CHUNKS_MAX * cc;
  const int nq = min(CHUNKS_MAX, (C - c0 + cc - 1) / cc);
  uint32_t* Gs = smem;                        // [STAGES][s2][16][SG]
  // feat chunks, [STAGES] of [cc][s2 SG] (float32, rows as they lie) or
  // [s2][cc][SG] (bfloat16)
  uint32_t* Os = Gs + STAGES * s2 * 16 * SG;
  const int sw = s2 * SG;
  const size_t plane = (size_t)H * W;
  const T* gb = g + (size_t)b * n * n * plane;
  const T* fb = feat + (size_t)b * C * plane;
  const int pi = warp / wpc, wc = warp % wpc;

  const RowCopy rc = row_copy(X0, W, md, s2, n, span, feat);
  int fcol[COL_SLOTS];  // bf16 feat row: col -> (class, t) -> T-unit offset
  unsigned fok = 0;
#pragma unroll
  for (int i = 0; i < COL_SLOTS; ++i) {
    const int col = lane + 32 * i;
    const int t = col / s2, x = X0 - md + col;
    fcol[i] = MUL * (col % s2) * cc * SG + t;
    if (col < span && x >= 0 && x < W && t < 15 + n) fok |= 1u << i;
  }
  int pcl[PIX_SLOTS], pm[PIX_SLOTS];
  unsigned pok = 0;
#pragma unroll
  for (int i = 0; i < PIX_SLOTS; ++i) {
    const int xl = lane + 32 * i;
    pcl[i] = xl % s2;
    pm[i] = xl / s2;
    if (xl < xt && X0 + xl < W) pok |= 1u << i;
  }

  int lo, hi;
  dy_range(y, H, md, s2, n, SECOND, lo, hi);

  // G's entries off the band, and what no copy writes, stay zero
  for (int i = threadIdx.x; i < STAGES * s2 * (16 + cc) * SG;
       i += blockDim.x)
    smem[i] = 0u;
  __syncthreads();

  // G of dy row iy: entry (class, m, t) with t = m + j (grad_f1) or
  // m + n - 1 - j (grad_f2), for the n maps j of that row
  auto stage_g = [&](int buf, int iy) {
    const int dy = -md + iy * s2;
    uint32_t* dst = Gs + buf * s2 * 16 * SG;
    for (int j = warp; j < n; j += nw) {
      const int k = iy * n + j;
      const int yy = SECOND ? y - dy : y;
      const int shift = SECOND ? (n - 1 - j) * s2 - md : 0;
      const T* src = gb + ((size_t)k * H + yy) * W + X0 + shift;
#pragma unroll
      for (int i = 0; i < PIX_SLOTS; ++i) {
        const int xl = lane + 32 * i;
        const int x = X0 + xl + shift;
        if (xl < xt && x >= 0 && x < W && (SECOND || (pok >> i & 1)))
          put(dst, MUL * (pcl[i] * 16 + pm[i]) * SG + pm[i] +
                       (SECOND ? n - 1 - j : j),
              src + xl);
      }
    }
  };
  // chunk q of the other map's row y + dy (grad_f1) or y - dy (grad_f2)
  auto stage_f = [&](int buf, int iy, int q) {
    const int dy = -md + iy * s2;
    const int yy = SECOND ? y - dy : y + dy;
    uint32_t* dst = Os + buf * s2 * cc * SG;
    if constexpr (MUL == 1) {
      for (int r = warp * rc.rpw + lane / rc.lr; r < cc; r += nw * rc.rpw) {
        const int c = c0 + q * cc + r;
        const T* src =
            fb + ((size_t)(c < C ? c : 0) * H + yy) * W + X0 - md;
        uint32_t* d = dst + r * sw;
        for (int u = rc.u_lo + lane % rc.lr; u < rc.u_hi; u += rc.lr) {
          if (c < C)
            put_f(d + u * rc.unit, src + u * rc.unit, rc.vec);
          else
            zero_f(d + u * rc.unit, rc.vec);
        }
      }
    } else {  // [class][channel][t pairs]
      for (int r = warp; r < cc; r += nw) {
        const int c = c0 + q * cc + r;
        const T* src =
            fb + ((size_t)(c < C ? c : 0) * H + yy) * W + X0 - md;
#pragma unroll
        for (int i = 0; i < COL_SLOTS; ++i)
          if (fok >> i & 1)
            put_h(dst, 2 * r * SG + fcol[i],
                  c < C ? src + lane + 32 * i : nullptr);
      }
    }
  };

  const int nsteps = (hi - lo + 1) * nq;
  int iy_s = lo, q_s = 0;
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nsteps) {
      stage_f(k, iy_s, q_s);
      if (q_s == 0) stage_g((iy_s - lo) % STAGES, iy_s);
      if (++q_s == nq) q_s = 0, ++iy_s;
    }
    cp_commit();
  }

  float acc[CHUNKS_MAX][2][4];
#pragma unroll
  for (int a = 0; a < CHUNKS_MAX; ++a)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      acc[a][p][0] = acc[a][p][1] = acc[a][p][2] = acc[a][p][3] = 0.0f;
  uint32_t gh[KS][4], gl[KS][4];

  int iy = lo, q = 0;
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nsteps) {
      stage_f((s + STAGES - 1) % STAGES, iy_s, q_s);
      if (q_s == 0) stage_g((iy_s - lo) % STAGES, iy_s);
      if (++q_s == nq) q_s = 0, ++iy_s;
    }
    cp_commit();

    if (q == 0) {  // G's fragments for this dy, kept for all chunks
      const uint32_t* Gp = Gs + (((iy - lo) % STAGES) * s2 + pi) * 16 * SG;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const uint32_t w[4] = {Gp[gq * SG + 8 * k + tg],
                               Gp[(gq + 8) * SG + 8 * k + tg],
                               Gp[gq * SG + 8 * k + tg + 4],
                               Gp[(gq + 8) * SG + 8 * k + tg + 4]};
        split_frag<T, 4>(w, gh[k], gl[k]);
      }
    }
    // this warp's two 8-channel tiles of the chunk; the small 3xTF32 terms
    // and the big ones in separate sums, so consecutive products are
    // independent
    // word of (channel row, class pi, t = 8 k + tg): row s2 SG + pi + s2 t
    // (float32) or (pi cc + row) SG + t (bfloat16, t in word pairs)
    const uint32_t* Fp =
        Os + (s % STAGES) * s2 * cc * SG +
        (MUL == 1 ? ((2 * wc) * 8 + gq) * sw + pi + s2 * tg
                  : (pi * cc + (2 * wc) * 8 + gq) * SG + tg);
    const int rstep = MUL == 1 ? 8 * sw : 8 * SG;  // to the next tile
    const int kstep = MUL == 1 ? 8 * s2 : 8;       // to the next k-step
    const int hstep = MUL == 1 ? 4 * s2 : 4;       // to the k-step's half
    float d[2][4] = {}, e[2][4] = {};
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t* F = Fp + p * rstep + k * kstep;
        const uint32_t w[2] = {F[0], F[hstep]};
        split_frag<T, 2>(w, bh[p], bl[p]);
      }
      if (sizeof(T) == 4) {
        mma_tf32(e[0], gl[k], bh[0]);
        mma_tf32(e[1], gl[k], bh[1]);
      }
      mma_big<T>(d[0], gh[k], bh[0]);
      mma_big<T>(d[1], gh[k], bh[1]);
      if (sizeof(T) == 4) {
        mma_tf32(e[0], gh[k], bl[0]);
        mma_tf32(e[1], gh[k], bl[1]);
      }
    }
#pragma unroll
    for (int a = 0; a < CHUNKS_MAX; ++a) {
      if (a != q) continue;  // static register indices
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][p][i] += d[p][i] + e[p][i];
    }
    if (++q == nq) q = 0, ++iy;
  }
  cp_wait<0>();
  __syncthreads();

  // write out through shared memory (over Os: [cc][xt + 1] floats), one
  // chunk at a time, as coalesced rows of the gradient
  float* Ob = reinterpret_cast<float*>(Os);
  const int so = xt + 1;
  const float fc = (float)C;
#pragma unroll
  for (int a = 0; a < CHUNKS_MAX; ++a) {
    if (a >= nq) break;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int cl = (2 * wc + p) * 8 + 2 * tg;
      const int x0 = pi + s2 * gq, x1 = pi + s2 * (gq + 8);
      Ob[cl * so + x0] = acc[a][p][0];
      Ob[(cl + 1) * so + x0] = acc[a][p][1];
      Ob[cl * so + x1] = acc[a][p][2];
      Ob[(cl + 1) * so + x1] = acc[a][p][3];
    }
    __syncthreads();
    for (int r = warp; r < cc; r += nw) {
      const int c = c0 + a * cc + r;
      if (c >= C) break;
      T* o = grad + (((size_t)b * C + c) * H + y) * W + X0;
#pragma unroll
      for (int i = 0; i < PIX_SLOTS; ++i)
        if (pok >> i & 1)
          o[lane + 32 * i] = from_f<T>(Ob[r * so + lane + 32 * i] / fc);
    }
    __syncthreads();
  }
}

cudaError_t set_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int NT>
int launch_forward(const Plan& p, const void* f1, const void* f2, void* out,
                   int B, int C, int H, int W, int md, cudaStream_t stream) {
  const auto kernel =
      p.a_ring ? corr_forward<T, NT, true> : corr_forward<T, NT, false>;
  cudaError_t e = set_smem((const void*)kernel, p.fwd_smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(p.tiles_x, H, B), 32 * p.nw, p.fwd_smem, stream>>>(
      (const T*)f1, (const T*)f2, (T*)out, C, H, W, md, p.s2, p.n, p.wpc,
      p.nq);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int launch_backward(const Plan& p, const void* g, const void* f1,
                    const void* f2, void* g1, void* g2, int B, int C, int H,
                    int W, int md, cudaStream_t stream) {
  cudaError_t e = set_smem((const void*)corr_backward<T, NT, false>,
                           p.bwd_smem);
  if (e == cudaSuccess)
    e = set_smem((const void*)corr_backward<T, NT, true>, p.bwd_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.tiles_x, H, B * p.groups);
  corr_backward<T, NT, false><<<grid, 32 * p.nw, p.bwd_smem, stream>>>(
      (const T*)g, (const T*)f2, (T*)g1, C, H, W, md, p.s2, p.n, p.wpc,
      p.groups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  corr_backward<T, NT, true><<<grid, 32 * p.nw, p.bwd_smem, stream>>>(
      (const T*)g, (const T*)f1, (T*)g2, C, H, W, md, p.s2, p.n, p.wpc,
      p.groups);
  return (int)cudaGetLastError();
}

}  // namespace

// out[10]: forward grid x, y, z, threads, shared bytes; backward the same
// (per gradient kernel).  Returns 0, or a cudaError_t for a shape the
// kernels do not take.
extern "C" int jafpro_correlation_plan(int B, int C, int H, int W, int md,
                                       int s2, int dtype, int* out) {
  Plan p;
  const int rc = make_plan(B, C, H, W, md, s2, dtype, &p);
  if (rc) return rc;
  const int v[10] = {p.tiles_x, H, B, 32 * p.nw, p.fwd_smem,
                     p.tiles_x, H, B * p.groups, 32 * p.nw, p.bwd_smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t.
extern "C" int jafpro_correlation_forward(const void* f1, const void* f2,
                                          void* out, int B, int C, int H,
                                          int W, int md, int s2, int dtype,
                                          cudaStream_t stream) {
  Plan p;
  const int rc = make_plan(B, C, H, W, md, s2, dtype, &p);
  if (rc) return rc;
  if (dtype == 0) {
    if (p.nt == 3)
      return launch_forward<float, 3>(p, f1, f2, out, B, C, H, W, md, stream);
    if (p.nt == 5)
      return launch_forward<float, 5>(p, f1, f2, out, B, C, H, W, md, stream);
    return launch_forward<float, 7>(p, f1, f2, out, B, C, H, W, md, stream);
  }
  if (p.nt == 3)
    return launch_forward<__nv_bfloat16, 3>(p, f1, f2, out, B, C, H, W, md,
                                            stream);
  if (p.nt == 5)
    return launch_forward<__nv_bfloat16, 5>(p, f1, f2, out, B, C, H, W, md,
                                            stream);
  return launch_forward<__nv_bfloat16, 7>(p, f1, f2, out, B, C, H, W, md,
                                          stream);
}

extern "C" int jafpro_correlation_backward(const void* g, const void* f1,
                                           const void* f2, void* g1,
                                           void* g2, int B, int C, int H,
                                           int W, int md, int s2, int dtype,
                                           cudaStream_t stream) {
  Plan p;
  const int rc = make_plan(B, C, H, W, md, s2, dtype, &p);
  if (rc) return rc;
  if (dtype == 0) {
    if (p.nt == 3)
      return launch_backward<float, 3>(p, g, f1, f2, g1, g2, B, C, H, W, md,
                                       stream);
    if (p.nt == 5)
      return launch_backward<float, 5>(p, g, f1, f2, g1, g2, B, C, H, W, md,
                                       stream);
    return launch_backward<float, 7>(p, g, f1, f2, g1, g2, B, C, H, W, md,
                                     stream);
  }
  if (p.nt == 3)
    return launch_backward<__nv_bfloat16, 3>(p, g, f1, f2, g1, g2, B, C, H,
                                             W, md, stream);
  if (p.nt == 5)
    return launch_backward<__nv_bfloat16, 5>(p, g, f1, f2, g1, g2, B, C, H,
                                             W, md, stream);
  return launch_backward<__nv_bfloat16, 7>(p, g, f1, f2, g1, g2, B, C, H, W,
                                           md, stream);
}
