// The seeded flood of one slice held in a thread-block cluster's shared
// memory (the cluster route of kernels 1 and 2), and kernel 1's cluster
// kernel.
//
// Same function and fixpoint as ctt_flood_slice (flood.cuh), and the same
// rounds: each round is the four Gauss-Seidel sweeps of flood.cuh (rows
// forward, rows backward, columns down, columns up), each sweep a scan
// (scan.cuh) that gives the sequential sweep's result exactly; a round ends
// with a cluster-wide vote and there is no round cap.
//
// What bounds it on an H100: the dependent steps of the sweeps, as in
// flood.cuh, but each step is now a shared-memory access or a shuffle
// instead of an L2 round trip, and a sweep is ~E + 5 + E steps of a lane
// (E = 8 at 256 wide) instead of 256.  The slice's state is loaded from
// device memory once and the labels are stored once.  Phase 2 needs no
// altitudes or heights: after phase 1 the edge test A(p) == max(A(q), h(p))
// of each sweep direction is folded into 4 bits of the flag byte, and the
// hop counts take the heights' place.
#pragma once

#include "flood.cuh"
#include "scan.cuh"

// Flood the band of one slice.  On entry `hm` holds the heights, `lab` the
// seeds (0 = unlabeled), `fl` the mask bit `mbit`; `dist` may alias `hm`.
// On exit `lab` holds the labels, 0 off the mask.  `summ` holds 24*W bytes,
// `vote` is zero and `*vstamp` the last vote stamp used.  Every thread of
// every CTA of the cluster must call it.  `stamps` (or null) receives the
// time after the set-up, phase 1 and phase 2; `rounds` (or null) the round
// counts of both phases.
__device__ void ctt_flood_band(cg::cluster_group& cl, const CttBand& b, float* alt, float* hm,
                               int* dist, int* lab, unsigned char* fl, unsigned char mbit,
                               void* summ, int* vote, int* vstamp, int* rounds,
                               long long* stamps) {
  const int tid = threadIdx.x, nth = blockDim.x, n = b.rows * b.W;
  for (int p = tid; p < n; p += nth) {
    const int i = b.idx(p / b.W, p % b.W);
    const bool m = (fl[i] & mbit) != 0;
    const int s = m ? lab[i] : 0;
    lab[i] = s;
    alt[i] = s > 0 ? hm[i] : CTT_BIG;
    if (!m) hm[i] = INFINITY;  // off the mask: the constant transfer BIG
  }
  __syncthreads();
  ctt_stamp(stamps, 0);

  // -- phase 1: altitude ---------------------------------------------------------
  const CttAltOp aop{alt, hm};
  int r1 = 0;
  for (;;) {
    int changed = 0;
    ctt_row_sweep(aop, b, 0, changed);
    __syncthreads();
    ctt_row_sweep(aop, b, 1, changed);
    __syncthreads();
    ctt_col_sweep(aop, cl, b, 2, summ, changed);
    __syncthreads();
    ctt_col_sweep(aop, cl, b, 3, summ, changed);
    ++r1;
    if (!ctt_cluster_vote(cl, changed, vote, ++*vstamp)) break;
  }
  ctt_stamp(stamps, 1);

  // -- edge bits, then the hop counts in the heights' place -------------------
  // (the vote's barrier above ends every CTA's phase 1: neighbours' altitudes
  // are final; rows across the band border are read through DSMEM)
  for (int p = tid; p < n; p += nth) {
    const int r = p / b.W, j = p % b.W, g = b.row0 + r, i = b.idx(r, j);
    const int s = lab[i];
    unsigned char bits = 0;
    if ((fl[i] & mbit) && s == 0) {
      const float a = alt[i], h = hm[i];
      const float* up = g > 0 ? ctt_row_ptr(cl, alt, b, g - 1) : nullptr;
      const float* dn = g < b.H - 1 ? ctt_row_ptr(cl, alt, b, g + 1) : nullptr;
      const float prev[4] = {
          j > 0 ? alt[b.idx(r, j - 1)] : CTT_BIG,
          j < b.W - 1 ? alt[b.idx(r, j + 1)] : CTT_BIG,
          up ? up[ctt_swz(j)] : CTT_BIG,
          dn ? dn[ctt_swz(j)] : CTT_BIG,
      };
      for (int d = 0; d < 4; ++d)
        if (a == fmaxf(prev[d], h)) bits |= (unsigned char)(CTT_EDGE0 << d);
    }
    fl[i] = (unsigned char)((fl[i] & (CTT_EDGE0 - 1)) | bits);
    dist[i] = s > 0 ? 0 : CTT_BIG_DIST;
  }
  __syncthreads();

  // -- phase 2: (hops, label) over the optimal-prefix edges ------------------
  int r2 = 0;
  for (;;) {
    int changed = 0;
    for (int dir = 0; dir < 4; ++dir) {
      const CttAsgOp op{dist, lab, fl, (unsigned char)(CTT_EDGE0 << dir)};
      if (dir < 2)
        ctt_row_sweep(op, b, dir, changed);
      else
        ctt_col_sweep(op, cl, b, dir, summ, changed);
      if (dir < 3) __syncthreads();
    }
    ++r2;
    if (!ctt_cluster_vote(cl, changed, vote, ++*vstamp)) break;
  }
  ctt_stamp(stamps, 2);
  if (rounds != nullptr && tid == 0 && b.rank == 0) {
    rounds[0] = r1;
    rounds[1] = r2;
  }
}

// Bytes of dynamic shared memory of kernel 1's cluster kernel: alt, hm and
// lab (4 B) and the flag byte per band element, the column summaries and a
// few words.
__host__ __device__ inline size_t ctt_flood_cluster_bytes(int H, int W) {
  return ctt_band_elems(H, W) * 13 + ctt_summ_bytes(W) + CTT_MISC_BYTES;
}

// Kernel 1, cluster route: grid = N * CTT_CLUSTER CTAs in clusters of
// CTT_CLUSTER, one cluster per slice.  Arrays as ctt_flood_kernel's.
__global__ void __launch_bounds__(CTT_CL_THREADS, 1)
    ctt_flood_cluster_kernel(const float* __restrict__ hmap, const int* __restrict__ seeds,
                             const int* __restrict__ mask, int* __restrict__ out, int H,
                             int W, int* rounds, long long* stamps) {
  extern __shared__ __align__(16) unsigned char ctt_cl_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const CttBand b = ctt_band(H, W, (int)cl.block_rank());
  const int slice = blockIdx.x / CTT_CLUSTER, tid = threadIdx.x, nth = blockDim.x;
  const size_t ne = ctt_band_elems(H, W);
  float* alt = reinterpret_cast<float*>(ctt_cl_smem);
  float* hm = alt + ne;
  int* lab = reinterpret_cast<int*>(hm + ne);
  void* summ = lab + ne;
  int* misc = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(summ) + ctt_summ_bytes(W));
  unsigned char* fl = reinterpret_cast<unsigned char*>(misc) + CTT_MISC_BYTES;
  long long* st = stamps != nullptr && b.rank == 0
                      ? stamps + (size_t)slice * CTT_FLOOD_STAMPS : nullptr;
  ctt_stamp(st, 0);

  const size_t off = (size_t)slice * H * W + (size_t)b.row0 * W;
  const int n = b.rows * W;
  for (int p = tid; p < n; p += nth) {
    const int i = b.idx(p / W, p % W);
    hm[i] = hmap[off + p];
    lab[i] = seeds[off + p];
    fl[i] = mask[off + p] != 0 ? CTT_FLOOD : 0;
  }
  if (tid == 0) misc[0] = 0;
  int vstamp = 0;
  __syncthreads();
  cl.sync();  // every CTA's vote word is zero before any vote
  ctt_flood_band(cl, b, alt, hm, reinterpret_cast<int*>(hm), lab, fl, CTT_FLOOD, summ, misc,
                 &vstamp, rounds ? rounds + 2 * slice : nullptr, st ? st + 1 : nullptr);
  for (int p = tid; p < n; p += nth) out[off + p] = lab[b.idx(p / W, p % W)];
  cl.sync();  // no CTA leaves while another may still read its shared memory
}
