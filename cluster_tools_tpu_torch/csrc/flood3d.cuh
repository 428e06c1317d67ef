// The 3d seeded flood: kernel 3 (tile-local altitude warm start) and the
// global directional sweeps that finish it.
//
// Kernel 3 replaces cluster_tools_tpu/ops/pallas_flood.py::flood_tiles_warm
// (body _flood_tile_alt_kernel).  The sweeps replace no Pallas kernel: they
// are the counterpart of the XLA loops of
// cluster_tools_tpu/ops/watershed.py::_flood_scan_impl with the sequential
// sweeps _sweep_altitude_seq / _sweep_assign_seq.  Same two monotone phases
// as the per-slice flood (flood.cuh), over 6 neighbours:
//   phase 1  altitude   A(p) = min(A(p), max(A(q), h(p))),
//   phase 2  (hops, label) over optimal-prefix edges A(p) == max(A(q), h(p)),
//            smaller hop count first, then the smaller label; label 0 is +inf.
// Phase 2 always runs against the GLOBAL altitude fixpoint: a tile-local
// altitude can be pass-optimal without being prefix-optimal, and its hop
// count would survive to a different label (watershed.py:286-296).
//
// The mask and the seeds need no flags inside the sweeps.  The height map is
// read as h' = h on the mask and +inf off it: then max(carry, h') = +inf is
// never below an altitude (at most CTT_BIG), so voxels off the mask keep
// A = CTT_BIG, hops CTT_BIG_DIST and label 0, and pass on exactly the carry
// (CTT_BIG, CTT_BIG_DIST, 0) that the reference resets to there.  A seed
// starts at A = h and hops 0: max(carry, h) >= h and carry hops + 1 > 0, so
// it never changes either, as the reference's ~seed test demands.  Altitudes
// are copies of height values or CTT_BIG, with no arithmetic: the kernels and
// the plain versions agree exactly.
//
// Kernel 3: one thread block per (slice, th x tw tile).  The tile's h' and
// A live in shared memory, row stride tw + 1 so that the row sweeps' threads
// fall on distinct banks (8 B per voxel: 66 KB at 64 x 128); ragged edge
// tiles are cut to the slice.  Four line sweeps (rows forward and backward,
// columns down and up), one thread carrying the state along each line,
// until a block-wide __syncthreads_or vote sees no change: no round cap.
// Device traffic is 13 B per voxel (f32 h, i32 seeds, byte mask in; f32 A
// out); the rounds run in shared memory.
//
// Global sweeps: one launch per axis and direction over a (B, Z, H, W)
// batch, one thread per line, lines never leaving their block; a per-call
// device flag records a change and the host reads it once per round.  What
// bounds them on an H100 is the chain of dependent steps along each line
// (W or H of them for the in-plane axes) times the rounds, not bytes: each
// thread loads CTT_F3_UNROLL values of its line at once to keep that many in
// flight.
#pragma once

#include <cuda_runtime.h>

#ifndef CTT_BIG
#define CTT_BIG 3.0e38f
#define CTT_BIG_DIST 2147483646
#endif

#define CTT_F3_UNROLL 8

// -- kernel 3 -----------------------------------------------------------------

// One phase-1 sweep of a shared-memory line; returns 1 when an altitude fell.
__device__ inline int ctt_tile_alt_sweep(const float* hs, float* as, int start,
                                         int step, int len) {
  float carry = CTT_BIG;
  int changed = 0;
  for (int k = 0, p = start; k < len; ++k, p += step) {
    float a = as[p];
    const float cand = fmaxf(carry, hs[p]);
    if (cand < a) {
      a = cand;
      as[p] = a;
      changed = 1;
    }
    carry = a;
  }
  return changed;
}

// grid = N * gh * gw (slice-major, then tile row, tile column); dynamic
// shared memory 2 * th * (tw + 1) floats.  rounds (N * gh * gw,) or null.
__global__ void ctt_flood_tiles_warm_kernel(
    const float* __restrict__ hmap, const int* __restrict__ seeds,
    const unsigned char* __restrict__ mask, float* __restrict__ out, int H,
    int W, int th, int tw, int gh, int gw, int* rounds) {
  extern __shared__ float smem[];
  const int stride = tw + 1;
  float* hs = smem;
  float* as = smem + th * stride;
  int t = blockIdx.x;
  const int tx = t % gw;
  t /= gw;
  const int ty = t % gh;
  const int s = t / gh;
  const int r0 = ty * th, c0 = tx * tw;
  const int hh = min(th, H - r0), ww = min(tw, W - c0);
  const size_t off = (size_t)s * H * W;
  const int n = hh * ww;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ww, c = i - r * ww;
    const size_t g = off + (size_t)(r0 + r) * W + c0 + c;
    const bool m = mask[g] != 0;
    const float h = hmap[g];
    hs[r * stride + c] = m ? h : __int_as_float(0x7f800000);  // +inf off mask
    as[r * stride + c] = (m && seeds[g] > 0) ? h : CTT_BIG;
  }
  __syncthreads();
  int rr = 0;
  for (;;) {
    int changed = 0;
    for (int line = threadIdx.x; line < hh; line += blockDim.x)
      changed |= ctt_tile_alt_sweep(hs, as, line * stride, 1, ww);
    __syncthreads();
    for (int line = threadIdx.x; line < hh; line += blockDim.x)
      changed |= ctt_tile_alt_sweep(hs, as, line * stride + ww - 1, -1, ww);
    __syncthreads();
    for (int line = threadIdx.x; line < ww; line += blockDim.x)
      changed |= ctt_tile_alt_sweep(hs, as, line, stride, hh);
    __syncthreads();
    for (int line = threadIdx.x; line < ww; line += blockDim.x)
      changed |= ctt_tile_alt_sweep(hs, as, (hh - 1) * stride + line, -stride, hh);
    ++rr;
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ww, c = i - r * ww;
    out[off + (size_t)(r0 + r) * W + c0 + c] = as[r * stride + c];
  }
  if (rounds != nullptr && threadIdx.x == 0) rounds[blockIdx.x] = rr;
}

// -- global sweeps ------------------------------------------------------------

// Initial state of the 3d flood: h' (+inf off the mask), A (h on seeds, else
// CTT_BIG, lowered to `warm` where given), hops and labels.
__global__ void ctt_flood3d_init_kernel(
    const float* __restrict__ hmap, const int* __restrict__ seeds,
    const unsigned char* __restrict__ mask, const float* __restrict__ warm,
    float* __restrict__ hm, float* __restrict__ alt, int* __restrict__ dist,
    int* __restrict__ lab, long long n) {
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const bool m = mask[p] != 0;
    const int s = m ? seeds[p] : 0;
    const bool seed = s > 0;
    const float h = hmap[p];
    float a = seed ? h : CTT_BIG;
    if (warm != nullptr) a = fminf(a, warm[p]);
    hm[p] = m ? h : __int_as_float(0x7f800000);
    alt[p] = a;
    dist[p] = seed ? 0 : CTT_BIG_DIST;
    lab[p] = seed ? s : 0;
  }
}

// Geometry of the sweeps: lines of axis `axis` (0: z, 1: y, 2: x) of a
// (B, Z, H, W) batch.  Line i's first voxel (of the forward direction), the
// step between its voxels and its length.
struct Ctt3dLines {
  int Z, H, W;
  __device__ void line(int axis, long long i, long long* start, long long* step,
                       int* len) const {
    const long long hw = (long long)H * W;
    if (axis == 2) {  // i = (b * Z + z) * H + y
      *start = i * W;
      *step = 1;
      *len = W;
    } else if (axis == 1) {  // i = (b * Z + z) * W + x
      *start = (i / W) * hw + i % W;
      *step = W;
      *len = H;
    } else {  // i = b * H * W + (y * W + x)
      *start = (i / hw) * Z * hw + i % hw;
      *step = hw;
      *len = Z;
    }
  }
};

__global__ void ctt_alt_sweep3d_kernel(const float* __restrict__ hm,
                                       float* __restrict__ alt, Ctt3dLines g,
                                       int axis, int reverse, long long nlines,
                                       int* changed) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= nlines) return;
  long long p, step;
  int len;
  g.line(axis, i, &p, &step, &len);
  if (reverse) {
    p += (len - 1) * step;
    step = -step;
  }
  float carry = CTT_BIG;
  int ch = 0;
  for (int k0 = 0; k0 < len; k0 += CTT_F3_UNROLL) {
    float a[CTT_F3_UNROLL], h[CTT_F3_UNROLL];
#pragma unroll
    for (int j = 0; j < CTT_F3_UNROLL; ++j)
      if (k0 + j < len) {
        a[j] = alt[p + j * step];
        h[j] = hm[p + j * step];
      }
#pragma unroll
    for (int j = 0; j < CTT_F3_UNROLL; ++j) {
      if (k0 + j >= len) break;
      const float cand = fmaxf(carry, h[j]);
      if (cand < a[j]) {
        a[j] = cand;
        alt[p + j * step] = cand;
        ch = 1;
      }
      carry = a[j];
    }
    p += CTT_F3_UNROLL * step;
  }
  if (ch) *changed = 1;
}

__global__ void ctt_assign_sweep3d_kernel(const float* __restrict__ hm,
                                          const float* __restrict__ alt,
                                          int* __restrict__ dist,
                                          int* __restrict__ lab, Ctt3dLines g,
                                          int axis, int reverse,
                                          long long nlines, int* changed) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= nlines) return;
  long long p, step;
  int len;
  g.line(axis, i, &p, &step, &len);
  if (reverse) {
    p += (len - 1) * step;
    step = -step;
  }
  float c_alt = CTT_BIG;
  int c_dist = CTT_BIG_DIST, c_lab = 0;
  int ch = 0;
  for (int k0 = 0; k0 < len; k0 += CTT_F3_UNROLL) {
    float a[CTT_F3_UNROLL], h[CTT_F3_UNROLL];
    int d[CTT_F3_UNROLL], l[CTT_F3_UNROLL];
#pragma unroll
    for (int j = 0; j < CTT_F3_UNROLL; ++j)
      if (k0 + j < len) {
        const long long q = p + j * step;
        a[j] = alt[q];
        h[j] = hm[q];
        d[j] = dist[q];
        l[j] = lab[q];
      }
#pragma unroll
    for (int j = 0; j < CTT_F3_UNROLL; ++j) {
      if (k0 + j >= len) break;
      if (c_lab > 0 && a[j] == fmaxf(c_alt, h[j])) {
        const int cd = c_dist + 1;
        if (cd < d[j] || (cd == d[j] && (l[j] == 0 || c_lab < l[j]))) {
          d[j] = cd;
          l[j] = c_lab;
          dist[p + j * step] = cd;
          lab[p + j * step] = c_lab;
          ch = 1;
        }
      }
      c_alt = a[j];
      c_dist = d[j];
      c_lab = l[j];
    }
    p += CTT_F3_UNROLL * step;
  }
  if (ch) *changed = 1;
}
