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
//  * kernel 5: one CTA of CTT_K5_THREADS threads per (slice, tile), the
//    tile's labels in shared memory (tile_scan.cuh's layout, 4 B per
//    element: 35 KB at 64 x 128 with the lines' bookkeeping), read once
//    from the mask and written once to the output.  The background is
//    CttCcOp's sentinel CTT_SENT, which resets the carry exactly as
//    ctt_cc_sweep does for -1; the four sweeps are scans of the lines that
//    can change (tile_scan.cuh).  During the rounds a label is a tile
//    address, the key r << k | c of a voxel of the tile (2^k >= tw):
//    inside a tile the block-flat index base + (r0 + r) * W + c0 + c is
//    strictly increasing in (r, c) because c < ww <= W - c0 for every real
//    c, so keys keep every comparison and minimum of the ids and the
//    fixpoint in keys maps one to one onto the fixpoint in ids.  The
//    pointer jump is then a shift, a mask and a shared-memory read (no
//    division; CTT_CC_JUMPS reads in flight), and the store decodes each
//    root key once.  The jump is in place, so rounds may depend on the
//    order threads run in; labels do not.  What bounds a tile: the warps'
//    chains of dependent shuffles and shared-memory steps per line and the
//    jump's reads, times the rounds (3.5 on average at the components
//    workflow's blocks).  Ragged edge tiles keep the full tile's cuts with
//    identity transfers past the line's end.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "tile_scan.cuh"

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

// Threads per CTA of kernel 5: at 64 x 128 six CTAs fit an SM's shared
// memory and its registers; 256 threads ran slower.
#define CTT_K5_THREADS 128

// Bytes of dynamic shared memory per CTA for (th, tw) tiles: the labels and
// the lines' bookkeeping.
__host__ __device__ inline size_t ctt_cc_tiles_bytes(int th, int tw) {
  return (ctt_tile_elems(th, tw) + ctt_tile_book_ints(th, tw)) * 4;
}
// Bits of the column in a tile key r << k | c: the fewest with 2^k >= tw.
__host__ __device__ inline int ctt_key_bits(int tw) {
  int k = 0;
  while ((1 << k) < tw) ++k;
  return k;
}

// Kernel 5: grid = N * gh * gw (slice-major, then tile row, tile column);
// dynamic shared memory ctt_cc_tiles_bytes(th, tw).  rounds (N * gh * gw,)
// or null; stamps (N * gh * gw, CTT_TILE_STAMPS) where STAMPS.  Loops over
// the tile run rows by warp and columns by lane.
template <bool STAMPS>
__global__ void __launch_bounds__(CTT_K5_THREADS)
    ctt_cc_tiles_kernel(const unsigned char* __restrict__ mask, int* __restrict__ out, int depth,
                        int H, int W, int th, int tw, int gh, int gw, int* rounds,
                        long long* stamps) {
  extern __shared__ __align__(16) int ctt_k5_smem[];
  CttTileTimer<STAMPS> timer(STAMPS ? stamps + (size_t)blockIdx.x * CTT_TILE_STAMPS : nullptr);
  int* lab = ctt_k5_smem;
  int* book = lab + ctt_tile_elems(th, tw);
  const int S = ctt_band_stride(tw), kb = ctt_key_bits(tw), km = (1 << kb) - 1;
  const CttTile g = ctt_tile_of(H, W, th, tw, gh, gw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t off = (size_t)g.s * H * W + (size_t)g.r0 * W + g.c0;
  for (int r = warp; r < g.hh; r += nw)
#pragma unroll 4
    for (int c = lane; c < g.ww; c += 32)
      lab[r * S + ctt_swz(c)] = mask[off + (size_t)r * W + c] ? r << kb | c : CTT_SENT;
  for (int i = threadIdx.x; i < (int)ctt_tile_book_ints(th, tw); i += blockDim.x) book[i] = 0;
  __syncthreads();
  timer.lap(0);
  const CttCcOp op{lab};
  int rr = 0;
  for (;;) {
    int changed = 0;
    ctt_tile_axis<CttCcOp, true>(op, book, S, th, tw, g.hh, g.ww, rr, changed);
    __syncthreads();
    timer.lap(1);
    ctt_tile_axis<CttCcOp, false>(op, book, S, th, tw, g.hh, g.ww, rr, changed);
    __syncthreads();
    timer.lap(2);
    // pointer jump: each key v to the label at voxel v, CTT_CC_JUMPS reads in
    // flight; a change marks the voxel's row and column for the next round
    for (int r = warp; r < g.hh; r += nw)
      for (int j0 = lane; j0 < g.ww; j0 += 32 * CTT_CC_JUMPS) {
        int v[CTT_CC_JUMPS], u[CTT_CC_JUMPS];
#pragma unroll
        for (int k = 0; k < CTT_CC_JUMPS; ++k) {
          const int j = j0 + 32 * k;
          v[k] = j < g.ww ? lab[r * S + ctt_swz(j)] : CTT_SENT;
        }
#pragma unroll
        for (int k = 0; k < CTT_CC_JUMPS; ++k)
          u[k] = v[k] != CTT_SENT ? lab[(v[k] >> kb) * S + ctt_swz(v[k] & km)] : CTT_SENT;
#pragma unroll
        for (int k = 0; k < CTT_CC_JUMPS; ++k)
          if (u[k] < v[k]) {
            lab[r * S + ctt_swz(j0 + 32 * k)] = u[k];
            book[r] = book[th + j0 + 32 * k] = rr + 1;  // the row's and column's stamps
            changed = 1;
          }
      }
    ++rr;
    const int more = __syncthreads_or(changed);
    timer.lap(3);
    if (!more) break;
  }
  const int base = (g.s % depth) * H * W + g.r0 * W + g.c0;  // block-flat id of key 0
  for (int r = warp; r < g.hh; r += nw)
#pragma unroll 4
    for (int c = lane; c < g.ww; c += 32) {
      const int v = lab[r * S + ctt_swz(c)];
      out[off + (size_t)r * W + c] = v == CTT_SENT ? -1 : base + (v >> kb) * W + (v & km);
    }
  timer.lap(4);
  if (rounds != nullptr && threadIdx.x == 0) rounds[blockIdx.x] = rr;
}
