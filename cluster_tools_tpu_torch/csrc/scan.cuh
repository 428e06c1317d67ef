// Line sweeps as scans over a slice held in a thread-block cluster's shared
// memory: the layout, the transfer families and the sweeps shared by the
// cluster routes of kernel 1 (flood_cluster.cuh), kernel 2
// (dtws_cluster.cuh) and kernel 4 (cc_cluster.cuh); the 3d flood
// (flood3d.cuh) and the tile kernels 3 and 5 (tile_scan.cuh) scan their
// lines with the same transfer families.
//
// Layout.  One cluster of CTT_CLUSTER CTAs holds one H x W slice; CTA `rank`
// owns the band of rows [rank*R, min(H, rank*R + R)), R = ceil(H / 8), each
// field of the band in its shared memory with row stride S = W + W/32 made
// odd, element (r, j) at r*S + j + j/32.  The one padding word per 32
// elements keeps a warp's lanes on distinct banks when lane i holds the run
// of elements [i*E, i*E + E) of a row (E a power of two); the odd stride does
// the same for the lanes of a column.  Rows of other bands are read through
// distributed shared memory (ctt_row_ptr).
//
// Sweeps.  A Gauss-Seidel sweep along a line is a chain of per-element
// transfer functions of the incoming carry.  The three families used here
// are closed under composition, and composition is exact (min, max, integer
// adds and comparisons only), so a scan reproduces the sequential sweep bit
// for bit:
//   CttAltOp   flood phase 1, c -> min(u, max(c, l)) over float altitudes
//              (cluster_tools_tpu/ops/watershed.py::_sweep_altitude_assoc);
//   CttCcOp    min-label CC, the same clamp over int labels, CTT_SENT the
//              constant of a non-member (kernel 2's maxima CC, kernel 4's
//              background);
//   CttAsgOp   flood phase 2, (hops, label) -> minlex((D, L), (d + s, l)) or
//              the constant (D, L) (_sweep_assign_assoc).
// A row sweep is one warp per row: each lane composes its run, a 5-step
// __shfl_up scan composes the runs, and each lane applies its exclusive
// prefix to the initial carry and walks its run.  A column sweep is a
// two-level scan: groups of P lanes scan the band's segment of a column the
// same way, publish the band's composed transfer in shared memory, and after
// a cluster barrier each CTA applies the transfers of the bands before it
// (at most 7, read through distributed shared memory) to the initial carry.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>

#include "defs.cuh"

namespace cg = cooperative_groups;

#define CTT_CLUSTER 8         // CTAs per cluster: the portable maximum
#define CTT_CL_THREADS 1024   // threads per CTA of the cluster kernels
#define CTT_SMEM_MAX 232448   // bytes of shared memory one H100 CTA may use
#define CTT_EDGE0 16  // flag bits 4..7: flood phase-2 edge into the voxel, per sweep

struct CttBand {
  int H, W, R, S, rank, row0, rows;
  __device__ int idx(int r, int j) const { return r * S + j + (j >> 5); }
};

__host__ __device__ inline int ctt_band_rows(int H) {
  return (H + CTT_CLUSTER - 1) / CTT_CLUSTER;
}
__host__ __device__ inline int ctt_band_stride(int W) { return (W + (W >> 5)) | 1; }
// elements of one band field, rounded up to 16 elements
__host__ __device__ inline size_t ctt_band_elems(int H, int W) {
  return ((size_t)ctt_band_rows(H) * ctt_band_stride(W) + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t ctt_align16(size_t b) { return (b + 15) & ~(size_t)15; }
// per-column summaries of both column directions: 2 * W transfers of <= 12 B
__host__ __device__ inline size_t ctt_summ_bytes(int W) { return ctt_align16((size_t)24 * W); }
#define CTT_MISC_BYTES 512  // vote word, reductions

__device__ inline CttBand ctt_band(int H, int W, int rank) {
  CttBand b;
  b.H = H;
  b.W = W;
  b.R = ctt_band_rows(H);
  b.S = ctt_band_stride(W);
  b.rank = rank;
  b.row0 = min(rank * b.R, H);
  b.rows = min(H, b.row0 + b.R) - b.row0;
  return b;
}

// Start of global row g of a band field `buf` (this CTA's pointer), in the
// CTA that owns the row: local shared memory or another CTA's through DSMEM.
template <typename T>
__device__ inline T* ctt_row_ptr(cg::cluster_group& cl, T* buf, const CttBand& b, int g) {
  const int owner = g / b.R;
  T* base = owner == b.rank ? buf : cl.map_shared_rank(buf, owner);
  return base + (g - owner * b.R) * b.S;
}
__device__ inline int ctt_swz(int j) { return j + (j >> 5); }

template <typename T>
__device__ inline T ctt_shfl_up(T v, int d, int width) {
  return __shfl_up_sync(0xffffffffu, v, d, width);
}
template <typename T>
__device__ inline T ctt_shfl_down(T v, int d, int width) {
  return __shfl_down_sync(0xffffffffu, v, d, width);
}
template <typename T>
__device__ inline T ctt_shfl(T v, int src, int width) {
  return __shfl_sync(0xffffffffu, v, src, width);
}

// -- transfer families ---------------------------------------------------------

// Flood phase 1: element (u, l) = (A(p), h(p)) with h = +inf off the mask,
// so a voxel off the mask is the constant BIG (the reference's reset carry)
// and a seed (A = h) the constant A: c -> min(u, max(c, l)).
struct CttAltOp {
  struct F { float u, l; };
  typedef float V;
  float* alt;
  const float* hm;
  __device__ static F identity() { return {INFINITY, -INFINITY}; }
  __device__ static F compose(F f, F g) {  // f first, then g
    return {fminf(g.u, fmaxf(f.u, g.l)), fmaxf(f.l, g.l)};
  }
  __device__ static V apply(F f, V c) { return fminf(f.u, fmaxf(c, f.l)); }
  __device__ static V init() { return CTT_BIG; }
  __device__ static F shfl_up(F f, int d, int w) {
    return {ctt_shfl_up(f.u, d, w), ctt_shfl_up(f.l, d, w)};
  }
  __device__ static F shfl_down(F f, int d, int w) {
    return {ctt_shfl_down(f.u, d, w), ctt_shfl_down(f.l, d, w)};
  }
  __device__ static V shfl_v(V v, int src, int w) { return ctt_shfl(v, src, w); }
  __device__ F load(int i) const { return {alt[i], hm[i]}; }
  __device__ void store(int i, V v) const { alt[i] = v; }
  __device__ V step(int i, F f, V c, int& changed) const {
    const float v = apply(f, c);
    if (v < f.u) {
      alt[i] = v;
      changed = 1;
    }
    return v;
  }
};

// Min-label CC (kernel 2's maxima, kernel 4's slices): a member holding root
// v is c -> min(v, c), a non-member (root CTT_SENT) the constant CTT_SENT,
// which resets the carry as the sequential sweep does.
struct CttCcOp {
  struct F { int u, l; };
  typedef int V;
  int* v;
  __device__ static F identity() { return {INT_MAX, INT_MIN}; }
  __device__ static F compose(F f, F g) { return {min(g.u, max(f.u, g.l)), max(f.l, g.l)}; }
  __device__ static V apply(F f, V c) { return min(f.u, max(c, f.l)); }
  __device__ static V init() { return CTT_SENT; }
  __device__ static F shfl_up(F f, int d, int w) {
    return {ctt_shfl_up(f.u, d, w), ctt_shfl_up(f.l, d, w)};
  }
  __device__ static F shfl_down(F f, int d, int w) {
    return {ctt_shfl_down(f.u, d, w), ctt_shfl_down(f.l, d, w)};
  }
  __device__ static V shfl_v(V x, int src, int w) { return ctt_shfl(x, src, w); }
  __device__ F load(int i) const {
    const int x = v[i];
    return {x, x == CTT_SENT ? CTT_SENT : INT_MIN};
  }
  __device__ void store(int i, V x) const { v[i] = x; }
  __device__ V step(int i, F f, V c, int& changed) const {
    const int x = apply(f, c);
    if (x < f.u) {
      v[i] = x;
      changed = 1;
    }
    return x;
  }
};

// Flood phase 2: keys (hops, label) in lexicographic order with label 0 as
// +inf; a label-0 key is always (CTT_BIG_DIST, 0), "unreached".  An element
// whose edge bit for this sweep is set (in the mask, not a seed, and
// A(p) == max(A(prev), h(p))) is c -> minlex((D, L), c + (s, 0)), s = 1;
// any other element is the constant (D, L).  s < 0 marks a constant.
struct CttAsgOp {
  struct F { int d, l, s; };
  struct V { int d, l; };
  int* dist;
  int* lab;
  const unsigned char* fl;
  unsigned char ebit;
  __device__ static bool less(int d1, int l1, int d2, int l2) {
    return d1 < d2 || (d1 == d2 && (unsigned)(l1 - 1) < (unsigned)(l2 - 1));
  }
  __device__ static V add(int d, int l, int s) {
    return l == 0 ? V{CTT_BIG_DIST, 0} : V{d + s, l};
  }
  __device__ static F identity() { return {CTT_BIG_DIST, 0, 0}; }
  __device__ static F compose(F f, F g) {
    if (g.s < 0) return g;
    const V c = add(f.d, f.l, g.s);
    const bool take = less(c.d, c.l, g.d, g.l);
    return {take ? c.d : g.d, take ? c.l : g.l, f.s < 0 ? -1 : f.s + g.s};
  }
  __device__ static V apply(F f, V c) {
    if (f.s < 0) return {f.d, f.l};
    const V a = add(c.d, c.l, f.s);
    return less(a.d, a.l, f.d, f.l) ? a : V{f.d, f.l};
  }
  __device__ static V init() { return {CTT_BIG_DIST, 0}; }
  __device__ static F shfl_up(F f, int d, int w) {
    return {ctt_shfl_up(f.d, d, w), ctt_shfl_up(f.l, d, w), ctt_shfl_up(f.s, d, w)};
  }
  __device__ static F shfl_down(F f, int d, int w) {
    return {ctt_shfl_down(f.d, d, w), ctt_shfl_down(f.l, d, w), ctt_shfl_down(f.s, d, w)};
  }
  __device__ static V shfl_v(V x, int src, int w) {
    return {ctt_shfl(x.d, src, w), ctt_shfl(x.l, src, w)};
  }
  __device__ F load(int i) const { return {dist[i], lab[i], (fl[i] & ebit) ? 1 : -1}; }
  __device__ V step(int i, F f, V c, int& changed) const {
    const V x = apply(f, c);
    if (x.d != f.d || x.l != f.l) {
      dist[i] = x.d;
      lab[i] = x.l;
      changed = 1;
    }
    return x;
  }
};

// -- scans -----------------------------------------------------------------------

// Inclusive scan of `x` over groups of `width` lanes (a power of two <= 32);
// q is the lane's index in its group.  Every lane of the warp must call it.
template <class Op>
__device__ inline typename Op::F ctt_group_scan(typename Op::F x, int q, int width) {
  for (int d = 1; d < width; d <<= 1) {
    const typename Op::F o = Op::shfl_up(x, d, width);
    if (q >= d) x = Op::compose(o, x);
  }
  return x;
}

// Exclusive prefix of the lane's run in its group (identity for q == 0).
template <class Op>
__device__ inline typename Op::F ctt_exclusive(typename Op::F inc, int q, int width) {
  const typename Op::F e = Op::shfl_up(inc, 1, width);
  return q == 0 ? Op::identity() : e;
}

// Exclusive scan of the runs' transfers over groups of `width` lanes in
// sweep order: lane order forward (rev 0), reversed lane order backward;
// the identity for the group's first lane in that order.  The 3d flood and
// the tile kernels (tile_scan.cuh) scan with it.  Every lane of the warp
// must call it.
template <class Op>
__device__ __forceinline__ typename Op::F ctt_group_exclusive(typename Op::F x, int q, int width,
                                                              int rev) {
  for (int d = 1; d < width; d <<= 1) {
    const typename Op::F o = rev ? Op::shfl_down(x, d, width) : Op::shfl_up(x, d, width);
    if (rev ? q + d < width : q >= d) x = Op::compose(o, x);
  }
  const typename Op::F e = rev ? Op::shfl_down(x, 1, width) : Op::shfl_up(x, 1, width);
  return (rev ? q == width - 1 : q == 0) ? Op::identity() : e;
}

// Lanes per line of `len` elements in runs of at most `run`: the fewest, a
// power of two at most 32, whose runs cover the line.
__host__ __device__ __forceinline__ int ctt_group_lanes(int len, int run) {
  int g = 1;
  while (g < 32 && g * run < len) g <<= 1;
  return g;
}

// Row sweep of every row of the band, forward (dir 0) or backward (dir 1):
// one warp per row, lane i owns the run of sweep positions [i*E, i*E + E).
template <class Op>
__device__ void ctt_row_sweep(const Op& op, const CttBand& b, int dir, int& changed) {
  typedef typename Op::F F;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int E = (b.W + 31) >> 5;
  const int k0 = min(lane * E, b.W), k1 = min(k0 + E, b.W);
  for (int r = threadIdx.x >> 5; r < b.rows; r += nw) {
    F acc = Op::identity();
    for (int k = k0; k < k1; ++k)
      acc = Op::compose(acc, op.load(b.idx(r, dir == 0 ? k : b.W - 1 - k)));
    const F exc = ctt_exclusive<Op>(ctt_group_scan<Op>(acc, lane, 32), lane, 32);
    typename Op::V c = Op::apply(exc, Op::init());
    for (int k = k0; k < k1; ++k) {
      const int i = b.idx(r, dir == 0 ? k : b.W - 1 - k);
      c = op.step(i, op.load(i), c, changed);
    }
  }
}

// Column sweep, down (dir 2) or up (dir 3), across the whole cluster.
// `summ` holds 2*W transfers of this CTA (one half per direction).  Groups
// of P lanes own a column, lane q the run of band rows [q*E, q*E + E) in
// sweep order.  Contains one cluster barrier; every thread of every CTA of
// the cluster must call it.
template <class Op>
__device__ void ctt_col_sweep(const Op& op, cg::cluster_group& cl, const CttBand& b,
                              int dir, void* summ, int& changed) {
  typedef typename Op::F F;
  typedef typename Op::V V;
  int P = 1;
  while (P < 32 && 2 * P * b.W <= (int)blockDim.x) P <<= 1;
  const int G = blockDim.x / P, q = threadIdx.x & (P - 1), grp = threadIdx.x / P;
  const int E = (b.rows + P - 1) / P;
  const int k0 = min(q * E, b.rows), k1 = min(k0 + E, b.rows);
  F* my = reinterpret_cast<F*>(summ) + (dir == 3 ? b.W : 0);
  auto row_of = [&](int k) { return dir == 2 ? k : b.rows - 1 - k; };
  auto lane_exclusive = [&](int c, bool publish) {
    F acc = Op::identity();
    if (c < b.W)
      for (int k = k0; k < k1; ++k) acc = Op::compose(acc, op.load(b.idx(row_of(k), c)));
    const F inc = ctt_group_scan<Op>(acc, q, P);
    if (publish && c < b.W && q == P - 1) my[c] = inc;  // the band's transfer
    return ctt_exclusive<Op>(inc, q, P);
  };
  F saved = Op::identity();
  for (int base = 0; base < b.W; base += G) saved = lane_exclusive(base + grp, true);
  cl.sync();
  for (int base = 0; base < b.W; base += G) {
    const int c = base + grp;
    const F exc = b.W <= G ? saved : lane_exclusive(c, false);
    V cin = Op::init();
    if (q == 0 && c < b.W) {
      if (dir == 2) {
        for (int o = 0; o < b.rank; ++o) cin = Op::apply(cl.map_shared_rank(my, o)[c], cin);
      } else {
        for (int o = CTT_CLUSTER - 1; o > b.rank; --o)
          cin = Op::apply(cl.map_shared_rank(my, o)[c], cin);
      }
    }
    V v = Op::apply(exc, Op::shfl_v(cin, 0, P));
    if (c < b.W)
      for (int k = k0; k < k1; ++k) {
        const int i = b.idx(row_of(k), c);
        v = op.step(i, op.load(i), v, changed);
      }
  }
}

// Lets `kernel` take up to CTT_SMEM_MAX bytes of dynamic shared memory on the
// current device; set once per device (a bit of `done` each).  The attribute
// is the process's and the wrappers launch from several host threads with
// slices of different sizes, so it is only ever set to the one value that
// covers every launch the size rule allows, never to one launch's size.
inline cudaError_t ctt_allow_smem_max(const void* kernel,
                                      std::atomic<unsigned long long>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done->load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CTT_SMEM_MAX);
  if (e == cudaSuccess) done->fetch_or(bit);
  return e;
}

// Launch configuration of a cluster kernel over n slices: n clusters of
// CTT_CLUSTER CTAs of `threads` threads, `smem` bytes each.
inline cudaLaunchConfig_t ctt_cluster_config(int n, size_t smem, cudaStream_t stream,
                                             cudaLaunchAttribute* attr,
                                             int threads = CTT_CL_THREADS) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * CTT_CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CTT_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// End of a round: true when any thread of any CTA of the cluster changed
// something.  `vote` is a word of every CTA's shared memory, zero at the
// start: a CTA that changed something writes `stamp` into every CTA's word,
// and after the barrier each CTA reads its own.  `stamp` must grow by one
// per call, so no reset is needed: a word written in an earlier vote holds a
// smaller stamp, and every round holds another cluster barrier between one
// vote's read and the next vote's writes.
__device__ inline bool ctt_cluster_vote(cg::cluster_group& cl, int changed, int* vote,
                                        int stamp) {
  if (__syncthreads_or(changed) && threadIdx.x < CTT_CLUSTER)
    *cl.map_shared_rank(vote, threadIdx.x) = stamp;
  cl.sync();
  return *(volatile int*)vote == stamp;
}
