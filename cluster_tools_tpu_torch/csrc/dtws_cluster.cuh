// Kernel 2, cluster route: the whole per-slice DT-watershed of dtws.cuh with
// the slice held in a thread-block cluster's shared memory.
//
// Same function, same float operations in the same order (every one an
// explicit round-to-nearest intrinsic; the build passes --fmad=false), so
// labels, roots and height map equal ctt_dtws_kernel's and the plain
// version's bit for bit.  What changes is where the state lives and how the
// line recurrences run:
//   - one cluster of CTT_CLUSTER CTAs per slice, each CTA a band of rows
//     (scan.cuh) with five fields in shared memory: the flag byte, three
//     float buffers B0-B2 and the int roots/labels L; x, mask and valid are
//     read from device memory once each (x twice) and labels, roots and
//     height map written once;
//   - column EDT: the last/next background row of a column composes by
//     max/min, so each CTA publishes its band's and reads the others';
//   - parabola: row-local, the min over j searched outwards from j = i and
//     stopped where (i - j)^2 reaches the best so far (exact: min is
//     order-free and no farther j can win);
//   - gaussians: along W row-local through a precomputed reflect table;
//     along H through a table of source-row pointers, rows of other bands
//     read through DSMEM (no modulo per tap);
//   - maxima: the 3 x 3 window reads one row of each neighbouring band;
//   - maxima CC: the clamp scans of scan.cuh along rows and columns, then
//     the diagonal pass in place (its racing reads see a member's old or new
//     root, both in the component; the vote reruns the round), so its round
//     count may differ from ctt_dtws_kernel's;
//   - height map: min and max of the distances as a cluster reduction;
//   - flood: ctt_flood_band (flood_cluster.cuh).
// Buffer use: B0 = g (squared column distance) -> H-gaussian of dt -> height
// map before its W-gaussian -> hop counts; B1 = dt -> height map; B2 =
// smoothed dt -> H-gaussian of the height map -> flood altitudes.
#pragma once

#include <cfloat>

#include "dtws.cuh"
#include "flood_cluster.cuh"

// Bytes of dynamic shared memory of kernel 2's cluster kernel for taps of at
// most `nt` (>= 1): four 4-byte fields and the flag byte per band element,
// the column summaries, a few words, the row-pointer and column tables.
__host__ __device__ inline size_t ctt_dtws_cluster_bytes(int H, int W, int nt) {
  return ctt_band_elems(H, W) * 17 + ctt_summ_bytes(W) + CTT_MISC_BYTES +
         ctt_align16((size_t)8 * (ctt_band_rows(H) + nt)) + ctt_align16((size_t)4 * (W + nt));
}

// out = correlation of the band field `in` with `taps` along H: taps summed
// left to right, one fused multiply-add each, numpy "symmetric" boundary.
// Reads rows of the other bands; the caller syncs the cluster before (in is
// complete everywhere) and keeps `in` unchanged until the cluster syncs again.
__device__ void ctt_band_conv_h(cg::cluster_group& cl, const CttBand& b, float* in,
                                float* out, const float* __restrict__ taps, int nt,
                                const float** rowtab) {
  const int r = nt / 2;
  for (int t = threadIdx.x; t < b.rows + nt - 1; t += blockDim.x)
    rowtab[t] = ctt_row_ptr(cl, in, b, ctt_reflect(b.row0 - r + t, b.H));
  __syncthreads();
  for (int p = threadIdx.x; p < b.rows * b.W; p += blockDim.x) {
    const int row = p / b.W, j = ctt_swz(p % b.W);
    float acc = 0.f;
    for (int k = 0; k < nt; ++k) {
      const float v = rowtab[row + k][j];
      acc = k == 0 ? __fmul_rn(taps[k], v) : __fmaf_rn(taps[k], v, acc);
    }
    out[row * b.S + j] = acc;
  }
  __syncthreads();
}

// The same along W, within each row of the band.
__device__ void ctt_band_conv_w(const CttBand& b, const float* in, float* out,
                                const float* __restrict__ taps, int nt, int* coltab) {
  const int r = nt / 2;
  for (int t = threadIdx.x; t < b.W + nt - 1; t += blockDim.x)
    coltab[t] = ctt_swz(ctt_reflect(t - r, b.W));
  __syncthreads();
  for (int p = threadIdx.x; p < b.rows * b.W; p += blockDim.x) {
    const int row = p / b.W, col = p % b.W;
    const float* src = in + row * b.S;
    float acc = 0.f;
    for (int k = 0; k < nt; ++k) {
      const float v = src[coltab[col + k]];
      acc = k == 0 ? __fmul_rn(taps[k], v) : __fmaf_rn(taps[k], v, acc);
    }
    out[b.idx(row, col)] = acc;
  }
  __syncthreads();
}

// grid = B*Z*CTT_CLUSTER CTAs in clusters of CTT_CLUSTER, one cluster per
// slice; arrays as ctt_dtws_kernel's (no device scratch).
__global__ void __launch_bounds__(CTT_CL_THREADS, 1) ctt_dtws_cluster_kernel(
    const float* __restrict__ x, const int* __restrict__ mask,
    const int* __restrict__ valid, int* __restrict__ labels, int* __restrict__ roots,
    float* __restrict__ hmap, int Z, int H, int W, float threshold, float alpha,
    float beta, int invert, const float* __restrict__ seed_taps, int n_seed,
    const float* __restrict__ weight_taps, int n_weight, int* rounds, long long* stamps) {
  extern __shared__ __align__(16) unsigned char ctt_cl_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const CttBand b = ctt_band(H, W, (int)cl.block_rank());
  const int slice = blockIdx.x / CTT_CLUSTER, z = slice % Z;
  const int tid = threadIdx.x, nth = blockDim.x, n = b.rows * W;
  const int nt = max(max(n_seed, n_weight), 1);
  const size_t ne = ctt_band_elems(H, W);
  float* B0 = reinterpret_cast<float*>(ctt_cl_smem);
  float* B1 = B0 + ne;
  float* B2 = B1 + ne;
  int* L = reinterpret_cast<int*>(B2 + ne);
  unsigned char* summ = reinterpret_cast<unsigned char*>(L + ne);
  int* misc = reinterpret_cast<int*>(summ + ctt_summ_bytes(W));
  const float** rowtab = reinterpret_cast<const float**>(
      reinterpret_cast<unsigned char*>(misc) + CTT_MISC_BYTES);
  int* coltab = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(rowtab) +
                                       ctt_align16((size_t)8 * (b.R + nt)));
  unsigned char* F = reinterpret_cast<unsigned char*>(coltab) + ctt_align16((size_t)4 * (W + nt));
  int* vote = misc;                                  // misc[0]
  float* red = reinterpret_cast<float*>(misc + 4);   // misc[4..5]: the band's (lo, hi)
  float* wred = reinterpret_cast<float*>(misc + 8);  // misc[8..71]: per-warp (lo, hi)
  long long* st = stamps != nullptr && b.rank == 0
                      ? stamps + (size_t)slice * CTT_DTWS_STAMPS : nullptr;
  const size_t off = (size_t)slice * H * W + (size_t)b.row0 * W;  // the band's first voxel
  x += off; mask += off; valid += off; labels += off; roots += off; hmap += off;
  ctt_stamp(st, 0);

  // -- 1. threshold ------------------------------------------------------------
  for (int p = tid; p < n; p += nth) {
    const bool fg = ctt_input(x, p, invert) < threshold && mask[p] != 0;
    F[b.idx(p / W, p % W)] = fg ? (CTT_FG | (valid[p] != 0 ? CTT_FLOOD : 0)) : 0;
  }
  if (tid == 0) vote[0] = 0;
  int vstamp = 0;
  __syncthreads();
  ctt_stamp(st, 1);

  // -- 2. squared EDT: columns across the bands, then the parabola -----------
  int2* bg = reinterpret_cast<int2*>(summ);  // the band's (last, first) background row
  for (int c = tid; c < W; c += nth) {
    int last = -1, first = INT_MAX;
    for (int r = 0; r < b.rows; ++r)
      if (!(F[b.idx(r, c)] & CTT_FG)) {
        if (first == INT_MAX) first = b.row0 + r;
        last = b.row0 + r;
      }
    bg[c] = make_int2(last, first);
  }
  cl.sync();
  for (int c = tid; c < W; c += nth) {
    int last = -1, next = INT_MAX;
    for (int o = 0; o < CTT_CLUSTER; ++o) {
      if (o == b.rank) continue;
      const int2 s = cl.map_shared_rank(bg, o)[c];
      if (o < b.rank) last = max(last, s.x);
      else next = min(next, s.y);
    }
    for (int r = 0; r < b.rows; ++r) {
      const int g = b.row0 + r, i = b.idx(r, c);
      if (!(F[i] & CTT_FG)) last = g;
      B0[i] = last < 0 ? CTT_BIG_DT : (float)(g - last);
    }
    for (int r = b.rows - 1; r >= 0; --r) {
      const int g = b.row0 + r, i = b.idx(r, c);
      if (!(F[i] & CTT_FG)) next = g;
      const float d = fminf(B0[i], next == INT_MAX ? CTT_BIG_DT : (float)(next - g));
      B0[i] = __fmul_rn(d, d);
    }
  }
  __syncthreads();
  ctt_stamp(st, 2);
  // min_j g_j + (i - j)^2 along the row, searched outwards from j = i: once
  // (i - j)^2 >= best no farther j can give less (g_j >= 0 and rounding is
  // monotone), so the result equals the dense min (dtws.cuh) bit for bit
  // while reading ~dt voxels instead of W.
  for (int p = tid; p < n; p += nth) {
    const int r = p / W, i = p % W;
    const float* g = B0 + r * b.S;
    float best = fminf(CTT_BIG_DT, g[ctt_swz(i)]);
    for (int t = 1; t < W; ++t) {
      const float tt = __fmul_rn((float)t, (float)t);
      if (tt >= best) break;
      if (i - t >= 0) best = fminf(best, __fadd_rn(g[ctt_swz(i - t)], tt));
      if (i + t < W) best = fminf(best, __fadd_rn(g[ctt_swz(i + t)], tt));
    }
    B1[b.idx(r, i)] = __fsqrt_rn(best);
  }
  __syncthreads();
  ctt_stamp(st, 3);

  // -- 3. seeds: smoothed-distance plateau maxima, 8-connected CC -------------
  float* sm = B1;
  if (n_seed > 0) {
    cl.sync();  // dt complete in every band (and the EDT summaries read)
    ctt_band_conv_h(cl, b, B1, B0, seed_taps, n_seed, rowtab);
    ctt_band_conv_w(b, B0, B2, seed_taps, n_seed, coltab);
    sm = B2;
  }
  cl.sync();  // the smoothed distances complete in every band
  ctt_stamp(st, 4);
  for (int p = tid; p < n; p += nth) {
    const int r = p / W, col = p % W, g = b.row0 + r, i = b.idx(r, col);
    const float v = sm[i];
    float m = v;
    for (int dy = -1; dy <= 1; ++dy) {
      const float* row = ctt_row_ptr(cl, sm, b, min(max(g + dy, 0), H - 1));
      for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, row[ctt_swz(min(max(col + dx, 0), W - 1))]);
    }
    const bool is_max = m == v && B1[i] > 0.f;
    if (is_max) F[i] |= CTT_MAX;
    L[i] = is_max ? (z * H + g) * W + col : CTT_SENT;
  }
  __syncthreads();
  ctt_stamp(st, 5);
  const CttCcOp cop{L};
  int r_cc = 0;
  for (;;) {
    int changed = 0;
    ctt_row_sweep(cop, b, 0, changed);
    __syncthreads();
    ctt_row_sweep(cop, b, 1, changed);
    __syncthreads();
    ctt_col_sweep(cop, cl, b, 2, summ, changed);
    __syncthreads();
    ctt_col_sweep(cop, cl, b, 3, summ, changed);
    __syncthreads();
    // diagonal neighbours, in place, rows of the neighbouring bands included
    for (int p = tid; p < n; p += nth) {
      const int r = p / W, col = p % W, g = b.row0 + r, i = b.idx(r, col);
      const int own = L[i];
      if (own == CTT_SENT) continue;
      int v = own;
      for (int dy = -1; dy <= 1; dy += 2) {
        if (g + dy < 0 || g + dy >= H) continue;
        const int* row = ctt_row_ptr(cl, L, b, g + dy);
        for (int dx = -1; dx <= 1; dx += 2) {
          if (col + dx < 0 || col + dx >= W) continue;
          const int q = row[ctt_swz(col + dx)];
          if (q != CTT_SENT) v = min(v, q);
        }
      }
      if (v < own) {
        L[i] = v;
        changed = 1;
      }
    }
    ++r_cc;
    if (!ctt_cluster_vote(cl, changed, vote, ++vstamp)) break;
  }
  ctt_stamp(st, 6);
  for (int p = tid; p < n; p += nth) {
    const int i = b.idx(p / W, p % W);
    const bool is_max = (F[i] & CTT_MAX) != 0;
    roots[p] = is_max ? L[i] : -1;
    L[i] = is_max ? L[i] + 1 : 0;  // the flood's seeds
  }

  // -- 4. height map -------------------------------------------------------------
  float lo = FLT_MAX, hi = -FLT_MAX;
  for (int p = tid; p < n; p += nth) {
    const float d = B1[b.idx(p / W, p % W)];
    lo = fminf(lo, d);
    hi = fmaxf(hi, d);
  }
  for (int s = 16; s > 0; s >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
  }
  if ((tid & 31) == 0) {
    wred[2 * (tid >> 5)] = lo;
    wred[2 * (tid >> 5) + 1] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (nth >> 5); ++w) {
      lo = fminf(lo, wred[2 * w]);
      hi = fmaxf(hi, wred[2 * w + 1]);
    }
    red[0] = lo;
    red[1] = hi;
  }
  cl.sync();
  if (tid == 0) {
    for (int o = 0; o < CTT_CLUSTER; ++o) {
      const float* rr = cl.map_shared_rank(red, o);
      lo = fminf(lo, rr[0]);
      hi = fmaxf(hi, rr[1]);
    }
    wred[0] = lo;
    wred[1] = hi;
  }
  __syncthreads();
  lo = wred[0];
  hi = wred[1];
  const float den = fmaxf(__fsub_rn(hi, lo), 1e-6f);
  float* h0 = n_weight > 0 ? B0 : B1;
  for (int p = tid; p < n; p += nth) {
    const int i = b.idx(p / W, p % W);
    const float dtn = __fdiv_rn(__fsub_rn(B1[i], lo), den);
    h0[i] = __fmaf_rn(alpha, ctt_input(x, p, invert), __fmul_rn(beta, __fsub_rn(1.f, dtn)));
  }
  if (n_weight > 0) {
    cl.sync();  // B0 complete in every band; every band's reduction read
    ctt_band_conv_h(cl, b, B0, B2, weight_taps, n_weight, rowtab);
    ctt_band_conv_w(b, B2, B1, weight_taps, n_weight, coltab);
  }
  __syncthreads();
  for (int p = tid; p < n; p += nth) hmap[p] = B1[b.idx(p / W, p % W)];
  __syncthreads();
  ctt_stamp(st, 7);

  // -- 5. flood (altitudes in B2, hop counts in B0: B0 is read by other bands'
  // H-gaussian until the flood's first cluster barrier, the hop counts are
  // written after phase 1) ----------------------------------------------------
  ctt_flood_band(cl, b, B2, B1, reinterpret_cast<int*>(B0), L, F, CTT_FLOOD, summ, vote,
                 &vstamp, rounds ? rounds + 3 * slice + 1 : nullptr, st ? st + 8 : nullptr);
  if (rounds != nullptr && tid == 0 && b.rank == 0) rounds[3 * slice] = r_cc;
  for (int p = tid; p < n; p += nth) labels[p] = L[b.idx(p / W, p % W)];
  cl.sync();  // no CTA leaves while another may still read its shared memory
}
