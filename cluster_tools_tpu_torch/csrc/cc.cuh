// Per-slice and per-tile 4-connected components: kernels 4 and 5.
//
// Replace cluster_tools_tpu/ops/pallas_cc.py::cc_slices (_cc_slice_kernel,
// fixpoint _cc_tile_fixpoint, sweeps _sweep_min) and ::cc_tiles (its inner
// `kernel`).  Both compute the same function as the TPU kernels: every
// foreground voxel gets the minimal flat index of its 4-connected component
// within the slice (kernel 4) or within its (th, tw) tile of the slice
// (kernel 5); background gets -1.  Flat indices are block-flat: slice s of an
// (N, H, W) stack is z = s % depth of its block, and voxel (row, col) has
// index (z * H + row) * W + col, so an (B * depth, H, W) batch numbers every
// block from 0 as the JAX package numbers one volume.
//
// Algorithm: labels start at the voxel's own flat index (-1 on background,
// which doubles as the mask inside the loop).  A round is four line sweeps
// (rows forward and backward, columns forward and backward), each carrying
// the running minimum along a run of foreground voxels, then one pointer
// jump per voxel (lab[p] <- lab[lab[p]]: a label is always the flat index of
// a voxel of the same component whose own label is not larger).  Rounds
// repeat until a block-wide vote (__syncthreads_or) sees no change.  There
// is NO cap on rounds: banded serpentine corridors need Theta(H*W)
// propagation steps.  At the fixpoint every run of a line is constant, so
// every component carries one value, its minimum — the TPU kernel's unique
// fixpoint, reached by sequential per-line carries instead of the TPU's
// log-depth shift-and-compose sweeps.
//
// Schedule and what bounds it on an H100:
//  * kernel 4: one thread block per slice, one thread per line.  A 256 x 256
//    int32 slice is 256 KB, over the 227 KB of shared memory a block may
//    use, so the labels live in the output buffer itself (device memory,
//    resident in the 50 MB L2 at the workflow's batch).  Device traffic is
//    5 B/voxel (mask in, labels out); the time goes to the chains of L2
//    accesses inside each line sweep, times the rounds.  Each sweep loads
//    CTT_CC_UNROLL values of its line at once to keep that many in flight.
//    This is kernel 4's global route: slices whose labels fit a cluster of
//    8 CTAs take the cluster route (cc_cluster.cuh) instead.
//  * kernel 5: one thread block per (slice, tile); the tile's labels live in
//    shared memory (row stride tw + 1, so the row sweeps' threads fall on
//    distinct banks), read once from the mask and written once to the
//    output.  Ragged edge tiles (H % th != 0 or W % tw != 0) are cut to the
//    slice.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#define CTT_CC_UNROLL 8

// One directional sweep of a line of `len` labels starting at lab[start],
// `step` apart.  Returns 1 when a label decreased.
__device__ inline int ctt_cc_sweep(int* lab, int start, int step, int len) {
  int carry = INT_MAX;
  int changed = 0;
  for (int k0 = 0; k0 < len; k0 += CTT_CC_UNROLL) {
    int v[CTT_CC_UNROLL];
#pragma unroll
    for (int j = 0; j < CTT_CC_UNROLL; ++j)
      if (k0 + j < len) v[j] = lab[start + (k0 + j) * step];
#pragma unroll
    for (int j = 0; j < CTT_CC_UNROLL; ++j) {
      if (k0 + j >= len) break;
      if (v[j] < 0) {
        carry = INT_MAX;
      } else if (carry < v[j]) {
        lab[start + (k0 + j) * step] = carry;
        changed = 1;
      } else {
        carry = v[j];
      }
    }
  }
  return changed;
}

// Kernel 4: grid = N slices.  mask (N, H, W) bytes, out (N, H, W) int32,
// rounds (N,) or null.
__global__ void ctt_cc_slices_kernel(const unsigned char* __restrict__ mask,
                                     int* out, int depth, int H, int W,
                                     int* rounds) {
  const int n = H * W;
  const size_t off = (size_t)blockIdx.x * n;
  const int base = (int)(blockIdx.x % depth) * n;
  int* lab = out + off;
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    lab[p] = mask[off + p] ? base + p : -1;
  __syncthreads();
  int r = 0;
  for (;;) {
    int changed = 0;
    for (int line = threadIdx.x; line < H; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, line * W, 1, W);
    __syncthreads();
    for (int line = threadIdx.x; line < H; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, line * W + W - 1, -1, W);
    __syncthreads();
    for (int line = threadIdx.x; line < W; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, line, W, H);
    __syncthreads();
    for (int line = threadIdx.x; line < W; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, (H - 1) * W + line, -W, H);
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int v = lab[p];
      if (v >= 0) {
        const int w = lab[v - base];
        if (w < v) {
          lab[p] = w;
          changed = 1;
        }
      }
    }
    ++r;
    if (!__syncthreads_or(changed)) break;
  }
  if (rounds != nullptr && threadIdx.x == 0) rounds[blockIdx.x] = r;
}

// Kernel 5: grid = N * gh * gw (slice-major, then tile row, tile column);
// dynamic shared memory th * (tw + 1) int32.  rounds (N * gh * gw,) or null.
__global__ void ctt_cc_tiles_kernel(const unsigned char* __restrict__ mask,
                                    int* __restrict__ out, int depth, int H,
                                    int W, int th, int tw, int gh, int gw,
                                    int* rounds) {
  extern __shared__ int lab[];
  const int stride = tw + 1;
  int t = blockIdx.x;
  const int tx = t % gw;
  t /= gw;
  const int ty = t % gh;
  const int s = t / gh;
  const int r0 = ty * th, c0 = tx * tw;
  const int hh = min(th, H - r0), ww = min(tw, W - c0);
  const size_t off = (size_t)s * H * W;
  const int base = (s % depth) * H * W;
  const int n = hh * ww;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ww, c = i - (i / ww) * ww;
    const int g = (r0 + r) * W + c0 + c;
    lab[r * stride + c] = mask[off + g] ? base + g : -1;
  }
  __syncthreads();
  int rr = 0;
  for (;;) {
    int changed = 0;
    for (int line = threadIdx.x; line < hh; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, line * stride, 1, ww);
    __syncthreads();
    for (int line = threadIdx.x; line < hh; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, line * stride + ww - 1, -1, ww);
    __syncthreads();
    for (int line = threadIdx.x; line < ww; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, line, stride, hh);
    __syncthreads();
    for (int line = threadIdx.x; line < ww; line += blockDim.x)
      changed |= ctt_cc_sweep(lab, (hh - 1) * stride + line, -stride, hh);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / ww, c = i - (i / ww) * ww;
      const int v = lab[r * stride + c];
      if (v >= 0) {
        const int g = v - base;
        const int q = (g / W - r0) * stride + (g % W - c0);
        const int w = lab[q];
        if (w < v) {
          lab[r * stride + c] = w;
          changed = 1;
        }
      }
    }
    ++rr;
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ww, c = i - (i / ww) * ww;
    out[off + (r0 + r) * W + c0 + c] = lab[r * stride + c];
  }
  if (rounds != nullptr && threadIdx.x == 0) rounds[blockIdx.x] = rr;
}
