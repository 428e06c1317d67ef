// The whole per-slice DT-watershed in one kernel (kernel 2).
//
// Replaces cluster_tools_tpu/ops/pallas_dtws.py::_dtws_slice_kernel
// (dtws_slices).  Per z-slice, in order:
//   1. fg = (x < threshold) & mask (x inverted first if asked); the flood
//      mask is fg & valid, the EDT sees fg only;
//   2. squared EDT: exact line distance along H (one thread per column,
//      forward and backward scans), then min_j g(j) + (i-j)^2 along W (one
//      row at a time in shared memory, one output column per thread),
//      clamped at 1e10, square root;
//   3. seeds: gaussian of the distances (tap sums left to right, one fused
//      multiply-add per tap, numpy "symmetric" boundary) -> 3x3 plateau
//      maxima with dt > 0 -> 8-connected min-label CC of the maxima, labelled
//      with the block-flat index (z*H + row)*W + col of its first voxel;
//   4. height map alpha*x + (1-alpha)*(1 - normalize(dt)), smoothed;
//   5. the flood of flood.cuh from the seeds (root + 1).
// Outputs: labels (block-flat root + 1, 0 off the flood mask), roots (-1 off
// the maxima) and the height map, which the host wrapper needs for the size
// filter.
//
// Float arithmetic: every operation is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, and __fmaf_rn where
// the JAX package's CPU build contracts a multiply-add: the gaussian taps and
// the height-map blend), the build passes --fmad=false so the compiler fuses
// nothing else, and the order is that of the plain PyTorch version
// (ops/cuda_dtws.py::dtws_slices_plain): the two agree bit for bit.
//
// What bounds it on an H100: operations, not bytes.  The dense min-plus
// parabola costs 2*W float ops per voxel against 24 B/voxel of device
// traffic; after it, the flood's dependent line sweeps dominate.  Design:
// one thread block per slice, per-slice fields in device-memory scratch (a
// dozen 256x256 fields do not fit the 227 KB of shared memory; they stay in
// the 50 MB L2 at these sizes), the parabola's source row in shared memory.
#pragma once

#include <cfloat>

#include "flood.cuh"

#define CTT_SENT 2147483646
#define CTT_BIG_DT 1e10f
#define CTT_FG 1
#define CTT_FLOOD 2
#define CTT_MAX 4

// numpy "symmetric" padding: source index of position q on an axis of n.
__device__ inline int ctt_reflect(int q, int n) {
  const int m = 2 * n;
  q %= m;
  if (q < 0) q += m;
  return q >= n ? m - 1 - q : q;
}

// out = correlation of `in` with `taps` along H (along_h) or W.
__device__ void ctt_conv(const float* in, float* out, int H, int W,
                         const float* __restrict__ taps, int nt, bool along_h) {
  const int r = nt / 2;
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) {
    const int row = p / W, col = p % W;
    float acc = 0.f;
    for (int k = 0; k < nt; ++k) {
      const float v = along_h ? in[ctt_reflect(row - r + k, H) * W + col]
                              : in[row * W + ctt_reflect(col - r + k, W)];
      acc = k == 0 ? __fmul_rn(taps[k], v) : __fmaf_rn(taps[k], v, acc);
    }
    out[p] = acc;
  }
  __syncthreads();
}

__device__ inline float ctt_input(const float* x, int p, int invert) {
  return invert ? __fsub_rn(1.f, x[p]) : x[p];
}

// grid = B*Z slices; all (N, H, W) arrays are offset per slice.  Dynamic
// shared memory: (W + 2*blockDim.x) floats; blockDim.x a power of two.
__global__ void ctt_dtws_kernel(
    const float* __restrict__ x, const int* __restrict__ mask,
    const int* __restrict__ valid, int* labels, int* roots, float* hmap,
    float* dt, float* tmp, float* alt, int* dist, unsigned char* flags, int Z,
    int H, int W, float threshold, float alpha, float beta, int invert,
    const float* __restrict__ seed_taps, int n_seed,
    const float* __restrict__ weight_taps, int n_weight, int* rounds) {
  extern __shared__ float ctt_smem[];
  const int n = H * W;
  const size_t off = (size_t)blockIdx.x * n;
  const int z = blockIdx.x % Z;
  x += off; mask += off; valid += off; labels += off; roots += off;
  hmap += off; dt += off; tmp += off; alt += off; dist += off; flags += off;
  const int tid = threadIdx.x, nth = blockDim.x;

  // -- 1. threshold ------------------------------------------------------------
  for (int p = tid; p < n; p += nth) {
    const bool fg = ctt_input(x, p, invert) < threshold && mask[p] != 0;
    flags[p] = fg ? (CTT_FG | (valid[p] != 0 ? CTT_FLOOD : 0)) : 0;
  }
  __syncthreads();

  // -- 2. squared EDT: columns, then the parabola along rows -----------------
  for (int col = tid; col < W; col += nth) {
    int last = -1;
    for (int i = 0; i < H; ++i) {
      const int p = i * W + col;
      if (!(flags[p] & CTT_FG)) last = i;
      tmp[p] = last < 0 ? CTT_BIG_DT : (float)(i - last);
    }
    int next = -1;
    for (int i = H - 1; i >= 0; --i) {
      const int p = i * W + col;
      if (!(flags[p] & CTT_FG)) next = i;
      const float d = fminf(tmp[p], next < 0 ? CTT_BIG_DT : (float)(next - i));
      tmp[p] = __fmul_rn(d, d);
    }
  }
  __syncthreads();
  float* row_g = ctt_smem;
  for (int r = 0; r < H; ++r) {
    for (int j = tid; j < W; j += nth) row_g[j] = tmp[r * W + j];
    __syncthreads();
    for (int i = tid; i < W; i += nth) {
      float best = CTT_BIG_DT;
      for (int j = 0; j < W; ++j) {
        const float dd = (float)(i - j);
        best = fminf(best, __fadd_rn(row_g[j], __fmul_rn(dd, dd)));
      }
      dt[r * W + i] = __fsqrt_rn(best);
    }
    __syncthreads();
  }

  // -- 3. seeds: smoothed-distance plateau maxima, 8-connected CC -------------
  const float* sm = dt;
  if (n_seed > 0) {
    ctt_conv(dt, tmp, H, W, seed_taps, n_seed, true);
    ctt_conv(tmp, alt, H, W, seed_taps, n_seed, false);
    sm = alt;
  }
  for (int p = tid; p < n; p += nth) {
    const int row = p / W, col = p % W;
    const float v = sm[p];
    float m = v;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const int rr = min(max(row + dy, 0), H - 1);
        const int cc = min(max(col + dx, 0), W - 1);
        m = fmaxf(m, sm[rr * W + cc]);
      }
    if (m == v && dt[p] > 0.f) flags[p] |= CTT_MAX;
    roots[p] = (flags[p] & CTT_MAX) ? (z * H + row) * W + col : CTT_SENT;
  }
  __syncthreads();
  int r_cc = 0;
  for (;;) {
    int changed = 0;
    for (int dir = 0; dir < 4; ++dir) {
      const int nlines = dir < 2 ? H : W;
      for (int line = tid; line < nlines; line += nth) {
        int p, step, len;
        ctt_line(dir, line, H, W, &p, &step, &len);
        int carry = CTT_SENT;
        for (int k = 0; k < len; ++k, p += step) {
          if (!(flags[p] & CTT_MAX)) {
            carry = CTT_SENT;
            continue;
          }
          int v = roots[p];
          if (carry < v) {
            v = carry;
            roots[p] = v;
            changed = 1;
          }
          carry = v;
        }
      }
      __syncthreads();
    }
    // diagonal neighbours, in place: a racing read sees the old or the new
    // label, both members of the component, and the vote reruns the round
    for (int p = tid; p < n; p += nth) {
      if (!(flags[p] & CTT_MAX)) continue;
      const int row = p / W, col = p % W;
      int v = roots[p];
      const int own = v;
      for (int dy = -1; dy <= 1; dy += 2)
        for (int dx = -1; dx <= 1; dx += 2) {
          const int rr = row + dy, cc = col + dx;
          if (rr < 0 || rr >= H || cc < 0 || cc >= W) continue;
          const int q = rr * W + cc;
          if (flags[q] & CTT_MAX) v = min(v, roots[q]);
        }
      if (v < own) {
        roots[p] = v;
        changed = 1;
      }
    }
    ++r_cc;
    if (!__syncthreads_or(changed)) break;
  }
  for (int p = tid; p < n; p += nth) {
    if (flags[p] & CTT_MAX) {
      labels[p] = roots[p] + 1;
    } else {
      roots[p] = -1;
      labels[p] = 0;
    }
  }

  // -- 4. height map ------------------------------------------------------------
  float* red = ctt_smem + W;
  float lo = FLT_MAX, hi = -FLT_MAX;
  for (int p = tid; p < n; p += nth) {
    lo = fminf(lo, dt[p]);
    hi = fmaxf(hi, dt[p]);
  }
  red[tid] = lo;
  red[nth + tid] = hi;
  __syncthreads();
  for (int s = nth / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] = fminf(red[tid], red[tid + s]);
      red[nth + tid] = fmaxf(red[nth + tid], red[nth + tid + s]);
    }
    __syncthreads();
  }
  lo = red[0];
  hi = red[nth];
  const float den = fmaxf(__fsub_rn(hi, lo), 1e-6f);
  float* h0 = n_weight > 0 ? tmp : hmap;
  for (int p = tid; p < n; p += nth) {
    const float dtn = __fdiv_rn(__fsub_rn(dt[p], lo), den);
    h0[p] = __fmaf_rn(alpha, ctt_input(x, p, invert),
                      __fmul_rn(beta, __fsub_rn(1.f, dtn)));
  }
  __syncthreads();
  if (n_weight > 0) {
    ctt_conv(tmp, dt, H, W, weight_taps, n_weight, true);
    ctt_conv(dt, hmap, H, W, weight_taps, n_weight, false);
  }

  // -- 5. flood ---------------------------------------------------------------
  ctt_flood_slice(hmap, BitMask{flags, CTT_FLOOD}, alt, dist, labels, H, W,
                  rounds ? rounds + 3 * blockIdx.x + 1 : nullptr);
  if (rounds != nullptr && tid == 0) rounds[3 * blockIdx.x] = r_cc;
}
