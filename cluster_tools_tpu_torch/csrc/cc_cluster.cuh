// Kernel 4's cluster route: the per-slice 4-connected CC with the slice's
// labels in a thread-block cluster's shared memory.
//
// Same function and fixpoint as ctt_cc_slices_kernel (cc.cuh): every
// foreground voxel gets the minimal block-flat index of its in-slice
// component, background -1.  Layout as scan.cuh's: one cluster of
// CTT_CLUSTER CTAs per slice, CTA `rank` the band of rows
// [rank*R, rank*R + R), R = ceil(H / 8), its labels in shared memory
// (4 B per element: 33,920 B at 256 x 256) with the background held as
// CTT_SENT, so that CttCcOp's non-member constant resets the carry exactly
// as cc.cuh's sequential sweep does.  A round is the same four sweeps as
// cc.cuh's (rows forward, backward, columns down, up), the rows as warp
// scans and the columns as the two-level cluster scan (scan.cuh), then one
// pointer jump per voxel (lab[p] <- lab[lab[p]], the target read through
// distributed shared memory where another band holds it), then a cluster
// vote; no round cap.  The jump is in place, so the round count may depend
// on the order in which threads run (as on the global route).
//
// CTAs of CTT_CC_CL_THREADS = 256 threads: the band is small, so several
// clusters share an SM (five CTAs per SM by shared memory at 256 x 256)
// and the workflow's 256 slices per launch run in 4 waves; 512-thread CTAs
// fit 30 clusters at once (registers), 9 waves, and were slower.
#pragma once

#include "scan.cuh"

#define CTT_CC_CL_THREADS 256

// Bytes of dynamic shared memory per CTA: the band's labels, the column
// summaries and the vote word.
__host__ __device__ inline size_t ctt_cc_cluster_bytes(int H, int W) {
  return ctt_band_elems(H, W) * 4 + ctt_summ_bytes(W) + CTT_MISC_BYTES;
}

// a / d for 0 <= a < 2^24 and d > 0 from inv = 1.0f / d: the float product
// is within one of the quotient, and one step either way fixes it.
__device__ __forceinline__ int ctt_div(int a, int d, float inv) {
  int q = __float2int_rz((float)a * inv);
  q -= q * d > a;
  q += (q + 1) * d <= a;
  return q;
}

// grid = N * CTT_CLUSTER CTAs in clusters of CTT_CLUSTER, one cluster per
// slice.  mask (N, H, W) bytes, out (N, H, W) int32, rounds (N,) or null.
// Loops over the band run rows by warp and columns by lane.
__global__ void __launch_bounds__(CTT_CC_CL_THREADS)
    ctt_cc_cluster_kernel(const unsigned char* __restrict__ mask, int* __restrict__ out,
                          int depth, int H, int W, int* rounds) {
  extern __shared__ __align__(16) unsigned char ctt_cl_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const CttBand b = ctt_band(H, W, (int)cl.block_rank());
  const int slice = blockIdx.x / CTT_CLUSTER, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  int* lab = reinterpret_cast<int*>(ctt_cl_smem);
  void* summ = lab + ctt_band_elems(H, W);
  int* vote = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(summ) + ctt_summ_bytes(W));
  const int base = (slice % depth) * H * W;  // block-flat index of the slice's first voxel
  const size_t off = (size_t)slice * H * W + (size_t)b.row0 * W;
  for (int r = warp; r < b.rows; r += nw)
    for (int j = lane; j < W; j += 32)
      lab[b.idx(r, j)] = mask[off + r * W + j] ? base + (b.row0 + r) * W + j : CTT_SENT;
  if (tid == 0) vote[0] = 0;
  __syncthreads();
  cl.sync();  // every CTA's vote word is zero before any vote

  const CttCcOp op{lab};
  const float inv_w = 1.0f / W, inv_r = 1.0f / b.R;
  int r = 0;
  for (;;) {
    int changed = 0;
    ctt_row_sweep(op, b, 0, changed);
    __syncthreads();
    ctt_row_sweep(op, b, 1, changed);
    __syncthreads();
    ctt_col_sweep(op, cl, b, 2, summ, changed);
    __syncthreads();
    ctt_col_sweep(op, cl, b, 3, summ, changed);
    __syncthreads();
    // pointer jump: each label v to the label at voxel v, CTT_CC_JUMPS reads in flight
    for (int row = warp; row < b.rows; row += nw)
      for (int j0 = lane; j0 < W; j0 += 32 * CTT_CC_JUMPS) {
        int v[CTT_CC_JUMPS], w[CTT_CC_JUMPS];
#pragma unroll
        for (int u = 0; u < CTT_CC_JUMPS; ++u) {
          const int j = j0 + 32 * u;
          v[u] = j < W ? lab[b.idx(row, j)] : CTT_SENT;
        }
#pragma unroll
        for (int u = 0; u < CTT_CC_JUMPS; ++u) {
          w[u] = CTT_SENT;
          if (v[u] != CTT_SENT) {
            const int q = v[u] - base, g = ctt_div(q, W, inv_w), o = ctt_div(g, b.R, inv_r);
            const int* src = o == b.rank ? lab : cl.map_shared_rank(lab, o);
            w[u] = src[(g - o * b.R) * b.S + ctt_swz(q - g * W)];
          }
        }
#pragma unroll
        for (int u = 0; u < CTT_CC_JUMPS; ++u)
          if (w[u] < v[u]) {
            lab[b.idx(row, j0 + 32 * u)] = w[u];
            changed = 1;
          }
      }
    ++r;
    if (!ctt_cluster_vote(cl, changed, vote, r)) break;
  }
  for (int row = warp; row < b.rows; row += nw)
    for (int j = lane; j < W; j += 32) {
      const int v = lab[b.idx(row, j)];
      out[off + row * W + j] = v == CTT_SENT ? -1 : v;
    }
  if (rounds != nullptr && tid == 0 && b.rank == 0) rounds[slice] = r;
  cl.sync();  // no CTA leaves while another may still read its shared memory
}
