// Per-slice seeded flood: device function shared by the standalone flood
// kernel (flood.cu) and the fused DT-watershed kernel (dtws.cu).
//
// Replaces cluster_tools_tpu/ops/pallas_flood.py::flood_arrays (the body of
// _flood_slice_kernel).  Same two monotone phases, same fixpoint:
//   phase 1  altitude   A(p) = min(A(p), max(A(q), h(p))) over 4-neighbours,
//   phase 2  (hops, label) over optimal-prefix edges A(p) == max(A(q), h(p)),
//            smaller hop count first, then the smaller label; label 0 is +inf
//            (ops/watershed.py::_minlex).
// Seeds keep their state and pass only their own altitude on (they do not
// conduct); voxels outside the mask neither change nor conduct.
//
// Schedule: one thread block per slice.  Each round is four Gauss-Seidel
// line sweeps (rows left/right, columns down/up); one thread carries the
// state along one line, sequentially.  The TPU kernel's log-depth
// shift-and-compose sweeps exist only because the TPU lacks a cheap per-lane
// carry; a GPU thread has one.  Rounds repeat until a block-wide vote
// (__syncthreads_or) sees no change: there is NO round cap — banded
// serpentine corridors need Theta(H*W) rounds.
//
// What bounds it on an H100: not bytes (16 B/voxel of device traffic) but the
// dependent chain of loads inside each line sweep, times the round count.
// The per-slice state (altitude, hops, labels) lives in device-memory scratch
// that stays in L2 at 256x256; a 256x256 float field alone (256 KB) exceeds
// the 227 KB of shared memory a block may use.
#pragma once

#include <cuda_runtime.h>

#define CTT_BIG 3.0e38f
#define CTT_BIG_DIST 2147483646

struct IntMask {
  const int* m;
  __device__ bool operator()(int p) const { return m[p] != 0; }
};

struct BitMask {
  const unsigned char* m;
  unsigned char bit;
  __device__ bool operator()(int p) const { return (m[p] & bit) != 0; }
};

// Line `line` of direction `dir` (0: rows forward, 1: rows backward,
// 2: columns forward, 3: columns backward) as start index, step and length.
__device__ inline void ctt_line(int dir, int line, int H, int W, int* start,
                                int* step, int* len) {
  if (dir < 2) {
    *len = W;
    *step = dir == 0 ? 1 : -1;
    *start = line * W + (dir == 0 ? 0 : W - 1);
  } else {
    *len = H;
    *step = dir == 2 ? W : -W;
    *start = line + (dir == 2 ? 0 : (H - 1) * W);
  }
}

// Flood one H x W slice.  On entry `lab` holds the seeds (0 = unlabeled);
// on exit it holds the labels, 0 outside the mask.  `alt` and `dist` are
// scratch of H*W each.  All threads of the block must call it.
template <typename Mask>
__device__ void ctt_flood_slice(const float* __restrict__ hm, Mask mk,
                                float* alt, int* dist, int* lab, int H, int W,
                                int* rounds) {
  const int n = H * W;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    int s = mk(p) ? lab[p] : 0;
    lab[p] = s;
    alt[p] = s > 0 ? hm[p] : CTT_BIG;
    dist[p] = s > 0 ? 0 : CTT_BIG_DIST;  // dist 0 marks a seed from here on
  }
  __syncthreads();

  // -- phase 1: altitude -----------------------------------------------------
  int r1 = 0;
  for (;;) {
    int changed = 0;
    for (int dir = 0; dir < 4; ++dir) {
      const int nlines = dir < 2 ? H : W;
      for (int line = threadIdx.x; line < nlines; line += blockDim.x) {
        int p, step, len;
        ctt_line(dir, line, H, W, &p, &step, &len);
        float carry = CTT_BIG;
        for (int k = 0; k < len; ++k, p += step) {
          if (!mk(p)) {
            carry = CTT_BIG;
            continue;
          }
          float a = alt[p];
          if (dist[p] != 0) {
            float cand = fmaxf(carry, hm[p]);
            if (cand < a) {
              a = cand;
              alt[p] = a;
              changed = 1;
            }
          }
          carry = a;
        }
      }
      __syncthreads();
    }
    ++r1;
    if (!__syncthreads_or(changed)) break;
  }

  // -- phase 2: (hops, label) over optimal-prefix edges ----------------------
  int r2 = 0;
  for (;;) {
    int changed = 0;
    for (int dir = 0; dir < 4; ++dir) {
      const int nlines = dir < 2 ? H : W;
      for (int line = threadIdx.x; line < nlines; line += blockDim.x) {
        int p, step, len;
        ctt_line(dir, line, H, W, &p, &step, &len);
        float c_alt = CTT_BIG;
        int c_dist = CTT_BIG_DIST;
        int c_lab = 0;
        for (int k = 0; k < len; ++k, p += step) {
          if (!mk(p)) {
            c_alt = CTT_BIG;
            c_dist = CTT_BIG_DIST;
            c_lab = 0;
            continue;
          }
          const float a = alt[p];
          int d = dist[p];
          int l = lab[p];
          if (d != 0 && c_lab > 0 && a == fmaxf(c_alt, hm[p])) {
            const int cd = c_dist + 1;
            if (cd < d || (cd == d && (l == 0 || c_lab < l))) {
              d = cd;
              l = c_lab;
              dist[p] = d;
              lab[p] = l;
              changed = 1;
            }
          }
          c_alt = a;
          c_dist = d;
          c_lab = l;
        }
      }
      __syncthreads();
    }
    ++r2;
    if (!__syncthreads_or(changed)) break;
  }
  if (rounds != nullptr && threadIdx.x == 0) {
    rounds[0] = r1;
    rounds[1] = r2;
  }
}

// Kernel 1: grid = slices.  seeds/mask/out/alt/dist are (N, H, W);
// `rounds` (N, 2) or null.
__global__ void ctt_flood_kernel(const float* __restrict__ hmap,
                                 const int* __restrict__ seeds,
                                 const int* __restrict__ mask, int* out,
                                 float* alt, int* dist, int H, int W,
                                 int* rounds) {
  const size_t off = (size_t)blockIdx.x * H * W;
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) out[off + p] = seeds[off + p];
  __syncthreads();
  ctt_flood_slice(hmap + off, IntMask{mask + off}, alt + off, dist + off,
                  out + off, H, W, rounds ? rounds + 2 * blockIdx.x : nullptr);
}
