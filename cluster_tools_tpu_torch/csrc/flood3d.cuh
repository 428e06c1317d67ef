// The 3d seeded flood: kernel 3 (tile-local altitude warm start) and the
// flood of a (B, Z, H, W) batch of blocks that finishes it.
//
// Kernel 3 replaces cluster_tools_tpu/ops/pallas_flood.py::flood_tiles_warm
// (body _flood_tile_alt_kernel).  The 3d flood replaces no Pallas kernel: it
// is the counterpart of the XLA loops of
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
// Kernel 3: one CTA of CTT_K3_THREADS threads per (slice, th x tw tile),
// the tile's h' and A in shared memory (tile_scan.cuh's layout, 8 B per
// element: 69 KB at 64 x 128 with the lines' bookkeeping); ragged edge
// tiles keep the full tile's cuts with identity transfers past the line's
// end.  A round is the four Gauss-Seidel sweeps (rows forward and
// backward, columns down and up) of the lines that can change, each a
// scan of CttAltOp transfers (tile_scan.cuh: rows 8 lanes each, columns 4
// at 64 x 128), then a __syncthreads_or vote: no round cap.  The scan is
// exact and a skipped line would not change, so every round leaves what
// the sequential sweeps leave and the rounds per tile are the sequential
// schedule's.  Device traffic is 13 B per voxel (f32 h, i32 seeds, byte
// mask in; f32 A out); the rounds run in shared memory, and what bounds a
// tile is the warps' chains of dependent shuffles and shared-memory steps
// per line, times the rounds (up to 10 at the seeded workflow's blocks),
// for 540 tiles that fill the card about twice.
//
// The 3d flood: one cooperative kernel per call runs both phases to their
// fixpoints (ctt_flood3d_kernel); the host syncs once, to read the round
// counts.  A round is the reference's six Gauss-Seidel sweeps, z, y, x, each
// forward then backward, then a vote.  Each sweep is a scan of the transfer
// families of scan.cuh (CttAltOp for phase 1, CttAsgOp for phase 2), exact,
// so every sweep leaves what the sequential sweep leaves and the round
// counts are the sequential loop's.  A line is cut into runs of at most
// CTT_F3_RUN consecutive elements, one per lane; a lane loads its run into
// its slots of shared memory once per axis and round, composes it, scans
// the runs' transfers (forward in lane order, backward in reverse lane
// order), walks the run from its carry, does the same backward, and stores
// what changed:
//   x (contiguous, W = 272 at the workflows' blocks): 16 lanes per line,
//     runs of 17, a shuffle scan; the 16 lanes move the line between the
//     batch and their slots together, coalesced (lane q elements q, q + 16,
//     ...), since each lane's own run would be a 68-byte-strided access;
//   z (stride H*W, Z = 36): 4 lanes per line, runs of 9, coalesced across
//     the 8 lines (consecutive x) of a warp;
//   y (stride W, H = 272): a block per strip of 32 columns of one (b, z)
//     slice, lanes across the columns (coalesced), warp w the rows
//     [w*17, w*17 + 17); the 16 warps' run transfers are scanned per column
//     through shared memory.
// Lines longer than 32 runs (x, z) or 16 runs (y) go in tiles of that many
// runs, the carry passed from tile to tile.  A line has the same owner in
// both directions, so a grid-wide barrier follows each axis, not each
// sweep: three per round, the third the vote's.  A round sweeps only the
// lines that can change: a flag per line and axis (Ctt3dFlags) is set when
// an element of the line changes in another axis's sweep.  Phase 2 reads no
// altitudes: after phase 1 the edge test A(p) == max(A(prev), h(p)) of each
// of the six sweep directions is one bit of a byte per voxel, and phase 2
// moves hops, labels and that byte (9 B per voxel, 8 B in phase 1).  Blocks
// of 512 threads with 87 KB of shared memory each (the lanes' slots, 9 B
// per element), one or two per SM by the batch's size (ctt_flood3d_blocks):
// the grid is the one wave of co-resident blocks that a cooperative launch
// allows, and all loops stride over it.  Blocks of a batch never exchange:
// no line crosses from one into the next.
// (Runs kept in registers instead spilled: ptxas held every element's
// address from its load to its store.)
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "scan.cuh"
#include "tile_scan.cuh"

#define CTT_F3_THREADS 512                  // threads per block of the 3d flood
#define CTT_F3_WARPS (CTT_F3_THREADS / 32)  // runs of a y strip's column
#define CTT_F3_RUN 17  // elements of a line a lane holds: 16 runs cover 272
static_assert(32 % CTT_F3_WARPS == 0, "a y strip's column scan is a group of lanes");
// Dynamic shared memory of the kernel (Ctt3dSmem): CTT_F3_RUN slots of 8 B
// and of 1 B per lane, the y sweep's summaries and carries, dirty masks.
#define CTT_F3_SLOTS (CTT_F3_THREADS + 1)
#define CTT_F3_SLOT_BYTES (CTT_F3_RUN * CTT_F3_SLOTS * 8)
#define CTT_F3_BIT_BYTES ((CTT_F3_RUN * CTT_F3_SLOTS + 3) & ~3)
#define CTT_F3_SUMM (CTT_F3_WARPS * 33 * 12)
#define CTT_F3_CARRY (2 * 32 * 8)
#define CTT_F3_SMEM \
  (CTT_F3_SLOT_BYTES + CTT_F3_BIT_BYTES + CTT_F3_SUMM + CTT_F3_CARRY + 4 * CTT_F3_THREADS + 32)

// -- kernel 3 -----------------------------------------------------------------

// Threads per CTA of kernel 3: at 116 registers a thread two CTAs run on an
// SM (three would fit its shared memory at 64 x 128).
#define CTT_K3_THREADS 256

// Bytes of dynamic shared memory per CTA for (th, tw) tiles: h', A and the
// lines' bookkeeping.
__host__ __device__ inline size_t ctt_flood_tiles_bytes(int th, int tw) {
  return (2 * ctt_tile_elems(th, tw) + ctt_tile_book_ints(th, tw)) * 4;
}

// grid = N * gh * gw (slice-major, then tile row, tile column); dynamic
// shared memory ctt_flood_tiles_bytes(th, tw).  rounds (N * gh * gw,) or
// null; stamps (N * gh * gw, CTT_TILE_STAMPS) where STAMPS.  Loops over the
// tile run rows by warp and columns by lane.
template <bool STAMPS>
__global__ void __launch_bounds__(CTT_K3_THREADS)
    ctt_flood_tiles_warm_kernel(const float* __restrict__ hmap, const int* __restrict__ seeds,
                                const unsigned char* __restrict__ mask, float* __restrict__ out,
                                int H, int W, int th, int tw, int gh, int gw, int* rounds,
                                long long* stamps) {
  extern __shared__ __align__(16) float ctt_k3_smem[];
  CttTileTimer<STAMPS> timer(STAMPS ? stamps + (size_t)blockIdx.x * CTT_TILE_STAMPS : nullptr);
  const int S = ctt_band_stride(tw);
  float* alt = ctt_k3_smem;
  float* hm = ctt_k3_smem + ctt_tile_elems(th, tw);
  int* book = reinterpret_cast<int*>(hm + ctt_tile_elems(th, tw));
  const CttTile g = ctt_tile_of(H, W, th, tw, gh, gw);
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const size_t off = (size_t)g.s * H * W + (size_t)g.r0 * W + g.c0;
  for (int r = threadIdx.x >> 5; r < g.hh; r += nw)
#pragma unroll 4
    for (int c = lane; c < g.ww; c += 32) {
      const size_t i = off + (size_t)r * W + c;
      const bool m = mask[i] != 0;
      const float h = hmap[i];
      hm[r * S + ctt_swz(c)] = m ? h : INFINITY;  // off the mask: the constant BIG
      alt[r * S + ctt_swz(c)] = m && seeds[i] > 0 ? h : CTT_BIG;
    }
  for (int i = threadIdx.x; i < (int)ctt_tile_book_ints(th, tw); i += blockDim.x) book[i] = 0;
  __syncthreads();
  timer.lap(0);
  const CttAltOp op{alt, hm};
  int rr = 0;
  for (;;) {
    int changed = 0;
    ctt_tile_axis<CttAltOp, true>(op, book, S, th, tw, g.hh, g.ww, rr, changed);
    __syncthreads();
    timer.lap(1);
    ctt_tile_axis<CttAltOp, false>(op, book, S, th, tw, g.hh, g.ww, rr, changed);
    ++rr;
    const int more = __syncthreads_or(changed);
    timer.lap(2);
    if (!more) break;
  }
  for (int r = threadIdx.x >> 5; r < g.hh; r += nw)
#pragma unroll 4
    for (int c = lane; c < g.ww; c += 32) out[off + (size_t)r * W + c] = alt[r * S + ctt_swz(c)];
  timer.lap(4);
  if (rounds != nullptr && threadIdx.x == 0) rounds[blockIdx.x] = rr;
}

// -- the 3d flood --------------------------------------------------------------

struct Ctt3dGeom {
  int B, Z, H, W;
};

// What a lane holds of one element of a line in a slot, for each phase:
// phase 1 the altitude and h', phase 2 the hops and the label; phase 2's
// edge bits of the axis (bit 0 forward, bit 1 backward) go to a byte slot
// beside it.  load/bits/store address the batch; f is the element's
// transfer given its edge bit `s` of the sweep's direction, step applies it
// to the carry, keeps the result and says whether the element changed.
struct Ctt3dAlt {
  typedef CttAltOp Op;
  static constexpr bool kBits = false;
  struct E { float a, h; };
  float* alt;
  const float* hm;
  __device__ __forceinline__ E load(long long i) const { return {alt[i], hm[i]}; }
  __device__ __forceinline__ unsigned char bits(long long) const { return 0; }
  __device__ __forceinline__ void store(long long i, const E& e) const { alt[i] = e.a; }
  __device__ __forceinline__ static Op::F f(const E& e, unsigned) { return {e.a, e.h}; }
  __device__ __forceinline__ static bool step(E& e, Op::V& c, unsigned) {
    c = Op::apply({e.a, e.h}, c);
    if (!(c < e.a)) return false;
    e.a = c;
    return true;
  }
};

struct Ctt3dAsg {
  typedef CttAsgOp Op;
  static constexpr bool kBits = true;
  struct E { int d, l; };
  int* dist;
  int* lab;
  const unsigned char* eb;
  int shift;  // 2 * axis: the axis's bits of the edge byte
  __device__ __forceinline__ E load(long long i) const { return {dist[i], lab[i]}; }
  __device__ __forceinline__ unsigned char bits(long long i) const { return (eb[i] >> shift) & 3; }
  __device__ __forceinline__ void store(long long i, const E& e) const {
    dist[i] = e.d;
    lab[i] = e.l;
  }
  __device__ __forceinline__ static Op::F f(const E& e, unsigned s) {
    return {e.d, e.l, s ? 1 : -1};
  }
  __device__ __forceinline__ static bool step(E& e, Op::V& c, unsigned s) {
    c = Op::apply(f(e, s), c);
    if (c.d == e.d && c.l == e.l) return false;
    e.d = c.d;
    e.l = c.l;
    return true;
  }
};

// Shared memory of a block: the lanes' slots, then the y sweep's column
// summaries and tile carries, the lanes' dirty masks and six counts.  Lane t's slot j
// is element j * CTT_F3_SLOTS + t: a warp's lanes hit distinct banks for one
// j, and so do a lane group's consecutive elements written by the x sweep's
// staged loads (the stride is odd).
struct Ctt3dSmem {
  unsigned char* raw;
  template <class X>
  __device__ __forceinline__ typename X::E* slots() const {
    return reinterpret_cast<typename X::E*>(raw);
  }
  __device__ __forceinline__ unsigned char* bits() const { return raw + CTT_F3_SLOT_BYTES; }
  __device__ __forceinline__ void* summ() const {
    return raw + CTT_F3_SLOT_BYTES + CTT_F3_BIT_BYTES;
  }
  __device__ __forceinline__ void* carry() const {
    return reinterpret_cast<unsigned char*>(summ()) + CTT_F3_SUMM;
  }
  __device__ __forceinline__ unsigned* dirty() const {
    return reinterpret_cast<unsigned*>(reinterpret_cast<unsigned char*>(carry()) + CTT_F3_CARRY);
  }
  // the block's counts of swept lines per phase and axis (with stamps)
  __device__ __forceinline__ int* counts() const {
    return reinterpret_cast<int*>(dirty() + CTT_F3_THREADS);
  }
};

// A lane's run of a line: n <= CTT_F3_RUN consecutive elements, held across
// both directions of an axis in the lane's slots.
template <class X>
struct Ctt3dRun {
  typedef typename X::Op Op;
  typename X::E* e;  // slot 0; slot j at e[j * CTT_F3_SLOTS]
  unsigned char* b;  // edge-bit slot 0
  int n;
  unsigned dirty;  // bit j: element j changed since the load
  unsigned fw, bw;  // bit j: element j's edge bit forward, backward

  __device__ __forceinline__ Ctt3dRun(const Ctt3dSmem& sm, int lane_slot)
      : e(sm.slots<X>() + lane_slot), b(sm.bits() + lane_slot), n(0), dirty(0) {}
  // the lane loads its own run, elements `stride` apart from `base`
  __device__ __forceinline__ void load(const X& x, long long base, int stride) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const long long i = base + (long long)j * stride;
      e[j * CTT_F3_SLOTS] = x.load(i);
      if (X::kBits) b[j * CTT_F3_SLOTS] = x.bits(i);
    }
    loaded();
  }
  // after the slots are filled: reset the dirty mask, gather the edge bits
  __device__ __forceinline__ void loaded() {
    dirty = fw = bw = 0;
    if (X::kBits)
      for (int j = 0; j < n; ++j) {
        const unsigned v = b[j * CTT_F3_SLOTS];
        fw |= (v & 1u) << j;
        bw |= (v >> 1) << j;
      }
  }
  // store what changed, and mark(j) for each such element j
  template <class Mark>
  __device__ __forceinline__ void store(const X& x, long long base, int stride,
                                        Mark mark) const {
    for (int j = 0; j < n; ++j)
      if (dirty >> j & 1) {
        x.store(base + (long long)j * stride, e[j * CTT_F3_SLOTS]);
        mark(j);
      }
  }
  // the run's transfer in sweep order
  __device__ __forceinline__ typename Op::F fold(int rev) const {
    typename Op::F acc = Op::identity();
    const unsigned s = rev ? bw : fw;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int j = rev ? n - 1 - k : k;
      acc = Op::compose(acc, X::f(e[j * CTT_F3_SLOTS], s >> j & 1));
    }
    return acc;
  }
  // walk the run in sweep order from carry c; returns the carry after it
  __device__ __forceinline__ typename Op::V walk(int rev, typename Op::V c) {
    const unsigned s = rev ? bw : fw;
    for (int k = 0; k < n; ++k) {
      const int j = rev ? n - 1 - k : k;
      if (X::step(e[j * CTT_F3_SLOTS], c, s >> j & 1)) dirty |= 1u << j;
    }
    return c;
  }
};

// The x sweep's staged transfers between a tile of a contiguous line
// (elements [0, tl) from `base`) and the slots of its G lanes, the group's
// first slot `g0`, runs of E: lane q moves elements q, q + G, ... so that
// the group's accesses to the batch are coalesced; element p is slot p % E
// of lane p / E.  Stores take the lanes' dirty masks from shared memory and
// mark(p) each element stored.
template <class X, class Mark>
__device__ __forceinline__ void ctt_f3_stage(const X& x, const Ctt3dSmem& sm, long long base,
                                             int tl, int E, int G, int q, int g0, bool store,
                                             Mark mark) {
  if (tl == 0) return;
  typename X::E* e = sm.slots<X>();
  const unsigned* dirty = sm.dirty();
  int l = q / E, j = q % E;
  for (int p = q; p < tl; p += G) {
    const int slot = j * CTT_F3_SLOTS + g0 + l;
    if (!store) {
      e[slot] = x.load(base + p);
      if (X::kBits) sm.bits()[slot] = x.bits(base + p);
    } else if (dirty[g0 + l] >> j & 1) {
      x.store(base + p, e[slot]);
      mark(p);
    }
    for (j += G; j >= E; j -= E) ++l;
  }
}

// Both sweeps of the z (or x) lines: G lanes of a warp per line, lane q the
// run [q*E, q*E + E) of a tile of G * CTT_F3_RUN elements (one tile where
// the line is not longer).  A one-tile line is loaded once and stored once
// for both directions; longer lines pass the carry from tile to tile and
// are loaded again for the backward sweep.  base(t): line t's first
// element; its elements are `stride` apart.  Contiguous lines (stride 1)
// are staged: the group moves them coalesced (ctt_f3_stage).  Only lines
// whose flag is set are swept (the flag is cleared, and *count, if given,
// counts it); marks(t) gives line t's mark(k), called for its element k
// when that changes.
template <class X, class Base, class Marks>
__device__ __forceinline__ void ctt_f3_lane_axis(const X& x, const Ctt3dSmem& sm,
                                                 long long lines, int len, int stride,
                                                 unsigned char* flag, Base base, Marks marks,
                                                 int* count, int& changed) {
  typedef typename X::Op Op;
  const int G = ctt_group_lanes(len, CTT_F3_RUN), lane = threadIdx.x & 31, q = lane & (G - 1);
  const int g0 = (threadIdx.x & ~31) + (lane & ~(G - 1));  // the group's first slot
  const int per = 32 / G, T = G * CTT_F3_RUN, nt = (len + T - 1) / T;
  const bool staged = stride == 1;
  const long long items = (lines + per - 1) / per;
  for (long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5; w < items;
       w += ((long long)gridDim.x * blockDim.x) >> 5) {
    const long long t = w * per + lane / G;
    const bool live = t < lines && flag[t];
    if (!__any_sync(0xffffffffu, live)) continue;
    __syncwarp();  // every lane has read its line's flag
    if (live && q == 0) {
      flag[t] = 0;
      if (count != nullptr) atomicAdd(count, 1);
    }
    const long long b0 = live ? base(t) : 0;
    const auto mark = marks(live ? t : 0);
    Ctt3dRun<X> run(sm, threadIdx.x);
    for (int rev = 0; rev < 2; ++rev) {
      typename Op::V c = Op::init();
      for (int i = 0; i < nt; ++i) {
        const int t0 = (rev ? nt - 1 - i : i) * T, tl = live ? min(T, len - t0) : 0;
        const int E = (tl + G - 1) / G, k0 = min(q * E, tl);
        const long long rb = b0 + (long long)(t0 + k0) * stride;
        run.n = min(E, tl - k0);
        if (nt > 1 || rev == 0) {
          if (staged) {
            __syncwarp();  // the slots' last readers are done
            ctt_f3_stage(x, sm, b0 + t0, tl, E, G, q, g0, false, [](int) {});
            __syncwarp();
            run.loaded();
          } else {
            run.load(x, rb, stride);
          }
        }
        c = run.walk(rev, Op::apply(ctt_group_exclusive<Op>(run.fold(rev), q, G, rev), c));
        c = Op::shfl_v(c, rev ? 0 : G - 1, G);  // the carry out of the tile
        if (nt > 1 || rev == 1) {
          changed |= run.dirty != 0;
          if (staged) {
            sm.dirty()[threadIdx.x] = run.dirty;
            __syncwarp();
            ctt_f3_stage(x, sm, b0 + t0, tl, E, G, q, g0, true,
                         [&](int p) { mark(t0 + p); });
          } else {
            run.store(x, rb, stride, [&](int j) { mark(t0 + k0 + j); });
          }
        }
      }
    }
  }
}

// Both sweeps of the y lines: a block per strip of 32 columns of a (b, z)
// slice, lane = column, warp w the run [w*E, w*E + E) of the rows of a tile
// of CTT_F3_WARPS * CTT_F3_RUN rows; the warps' run transfers are scanned
// per column through shared memory (CTT_F3_WARPS x 33 transfers; 2 x 32
// carries between tiles).  Every thread of the block must call it.
template <class X, class Marks>
__device__ __forceinline__ void ctt_f3_y_axis(const X& x, const Ctt3dGeom& g,
                                              const Ctt3dSmem& smem, unsigned char* flag,
                                              Marks marks, int* count, int& changed) {
  typedef typename X::Op Op;
  typedef typename Op::F F;
  typedef typename Op::V V;
  F* sm = reinterpret_cast<F*>(smem.summ());
  V* cs = reinterpret_cast<V*>(smem.carry());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = g.H, W = g.W, strips = (W + 31) >> 5;
  const int T = CTT_F3_WARPS * CTT_F3_RUN, nt = (H + T - 1) / T;
  const long long items = (long long)g.B * g.Z * strips;
  for (long long s = blockIdx.x; s < items; s += gridDim.x) {
    const int c = (int)(s % strips) * 32 + lane;
    const long long bz = s / strips, b0 = bz * H * W + c;
    const bool live = c < W && flag[bz * W + c];
    if (!__syncthreads_or(live)) continue;
    if (live && warp == 0) {
      flag[bz * W + c] = 0;
      if (count != nullptr) atomicAdd(count, 1);
    }
    const auto mark = marks(bz, live ? c : 0);
    Ctt3dRun<X> run(smem, threadIdx.x);
    for (int rev = 0; rev < 2; ++rev) {
      for (int i = 0; i < nt; ++i) {
        const int t0 = (rev ? nt - 1 - i : i) * T, tl = min(T, H - t0);
        const int E = (tl + CTT_F3_WARPS - 1) / CTT_F3_WARPS, k0 = min(warp * E, tl);
        const long long rb = b0 + (long long)(t0 + k0) * W;
        run.n = live ? min(E, tl - k0) : 0;
        if (nt > 1 || rev == 0) run.load(x, rb, W);
        sm[warp * 33 + lane] = run.fold(rev);
        __syncthreads();
        // thread t scans column t / WARPS with the group of WARPS lanes it
        // is in, holding the run that is (t % WARPS)-th in sweep order
        const int q = threadIdx.x % CTT_F3_WARPS, col = threadIdx.x / CTT_F3_WARPS;
        const int r = rev ? CTT_F3_WARPS - 1 - q : q;
        const F exc = ctt_group_exclusive<Op>(sm[r * 33 + col], q, CTT_F3_WARPS, 0);
        __syncthreads();
        sm[r * 33 + col] = exc;
        __syncthreads();
        const V cin = i == 0 ? Op::init() : cs[((i - 1) & 1) * 32 + lane];
        const V out = run.walk(rev, Op::apply(sm[warp * 33 + lane], cin));
        if (warp == (rev ? 0 : CTT_F3_WARPS - 1)) cs[(i & 1) * 32 + lane] = out;
        if (nt > 1 || rev == 1) {
          run.store(x, rb, W, [&](int j) { mark(t0 + k0 + j); });
          changed |= run.dirty != 0;
        }
      }
    }
  }
}

// Per line of each axis, a flag set while the line may have changed since
// its axis last swept it.  A forward and backward sweep leave a line at its
// own (one-dimensional) fixpoint, so a line whose flag is clear would not
// change: skipping it changes no value and no round count.  An element that
// changes sets the flags of the other two lines through it.
struct Ctt3dFlags {
  unsigned char* x;  // per x line (b, z, y)
  unsigned char* y;  // per y line (b, z, x)
  unsigned char* z;  // per z line (b, y, x)
};

// Axis a of a round (0: z, 1: y, 2: x), both directions, over the lines
// whose flag is set.  A line's marks find the flags of the lines crossing
// it from pointers computed once per line.
template <class X>
__device__ __forceinline__ void ctt_f3_axis(const X& x, const Ctt3dGeom& g, int a,
                                            const Ctt3dSmem& sm, const Ctt3dFlags& fl,
                                            int* count, int& changed) {
  const int Z = g.Z, H = g.H, W = g.W;
  const long long hw = (long long)H * W;
  if (a == 0) {  // line t = b * hw + y * W + x, element z
    ctt_f3_lane_axis(
        x, sm, g.B * hw, Z, (int)hw, fl.z, [=](long long t) { return t / hw * Z * hw + t % hw; },
        [=](long long t) {
          const long long b = t / hw;
          const int yx = (int)(t - b * hw), y = yx / W;
          unsigned char* fx = fl.x + b * Z * H + y;
          unsigned char* fy = fl.y + b * Z * W + (yx - y * W);
          return [=](int z) {
            fx[z * H] = 1;
            fy[z * W] = 1;
          };
        },
        count, changed);
  } else if (a == 1) {  // strip of (b * Z + z), column c, element y
    ctt_f3_y_axis(x, g, sm, fl.y,
                  [=](long long bz, int c) {
                    unsigned char* fx = fl.x + bz * H;
                    unsigned char* fz = fl.z + bz / Z * hw + c;
                    return [=](int y) {
                      fx[y] = 1;
                      fz[y * W] = 1;
                    };
                  },
                  count, changed);
  } else {  // line t = (b * Z + z) * H + y, element c
    ctt_f3_lane_axis(
        x, sm, g.B * Z * H, W, 1, fl.x, [=](long long t) { return t * W; },
        [=](long long t) {
          const long long bz = t / H;
          unsigned char* fy = fl.y + bz * W;
          unsigned char* fz = fl.z + bz / Z * hw + (t - bz * H) * W;
          return [=](int c) {
            fy[c] = 1;
            fz[c] = 1;
          };
        },
        count, changed);
  }
}

// Phase stamps: thread 0 of block 0 adds the time since `t` to acc[k] and
// restarts `t` (the card's %globaltimer, ns).  Read after a grid-wide
// barrier, the interval is the slowest block's work plus the barrier.
__device__ __forceinline__ long long ctt_f3_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
__device__ __forceinline__ void ctt_f3_lap(long long* acc, int k, long long& t) {
  if (acc != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    const long long now = ctt_f3_now();
    acc[k] += now - t;
    t = now;
  }
}

// End of a round: true when any thread of the grid changed something.  As
// ctt_cluster_vote: a block that changed something writes `stamp` (one more
// each call) into the word, and after the barrier every thread reads it; a
// round holds five more barriers between one vote's read and the next
// vote's writes, so the word needs no reset.
__device__ __forceinline__ bool ctt_grid_vote(cg::grid_group& grid, int changed, int* word,
                                              int stamp) {
  if (__syncthreads_or(changed) && threadIdx.x == 0) *(volatile int*)word = stamp;
  grid.sync();
  return *(volatile int*)word == stamp;
}

// The 3d flood of a (B, Z, H, W) batch, launched cooperatively (all blocks
// co-resident).  hm, alt, dist and eb are scratch of the batch's size, flags
// of B * (Z * H + Z * W + H * W) bytes (Ctt3dFlags), lab
// receives the labels (0 off the mask), warm is null or the phase-1 warm
// altitudes (used on the mask only).  state: [0] the vote word, zero at
// launch; [1], [2] receive the rounds of phase 1 and phase 2 (the last,
// unchanged round included).  stamps (or null, CTT_F3_STAMPS int64, zero at
// launch) receives the ns spent on: set-up, phase 1's z, y and x sweeps,
// the edge bits, phase 2's z, y and x sweeps; then the lines swept in all
// rounds of phase 1's z, y and x axes and of phase 2's.
// kBlocks: blocks per SM the registers are capped for (128 per thread for
// 1, 64 for 2; ctt_flood3d_blocks picks).
#define CTT_F3_STAMPS 14
template <int kBlocks>
__global__ void __launch_bounds__(CTT_F3_THREADS, kBlocks)
    ctt_flood3d_kernel(const float* __restrict__ hmap, const int* __restrict__ seeds,
                       const unsigned char* __restrict__ mask, const float* __restrict__ warm,
                       float* hm, float* alt, int* dist, int* lab, unsigned char* eb,
                       unsigned char* flags, int* state, long long* stamps, Ctt3dGeom g) {
  extern __shared__ __align__(16) unsigned char ctt_f3_smem[];
  const Ctt3dSmem sm{ctt_f3_smem};
  if (threadIdx.x < 6) sm.counts()[threadIdx.x] = 0;
  cg::grid_group grid = cg::this_grid();
  long long clock = ctt_f3_now();
  const long long hw = (long long)g.H * g.W, n = g.B * g.Z * hw;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.x * blockDim.x;
  const long long zh = (long long)g.B * g.Z * g.H, zw = (long long)g.B * g.Z * g.W;
  const Ctt3dFlags fl{flags, flags + zh, flags + zh + zw};
  const long long nflags = zh + zw + g.B * hw;
  for (long long p = t0; p < nflags; p += nt) flags[p] = 1;
  for (long long p = t0; p < n; p += nt) {
    const bool m = mask[p] != 0;
    const int s = m ? seeds[p] : 0;
    const float h = hmap[p];
    float a = s > 0 ? h : CTT_BIG;
    if (warm != nullptr && m) a = fminf(a, warm[p]);
    hm[p] = m ? h : INFINITY;
    alt[p] = a;
    dist[p] = s > 0 ? 0 : CTT_BIG_DIST;
    lab[p] = s > 0 ? s : 0;
  }
  grid.sync();
  ctt_f3_lap(stamps, 0, clock);
  int stamp = 0;

  // -- phase 1: altitude -----------------------------------------------------------
  const Ctt3dAlt alts{alt, hm};
  int r1 = 0;
  for (bool more = true; more;) {
    int changed = 0;
    for (int a = 0; a < 3; ++a) {
      ctt_f3_axis(alts, g, a, sm, fl, stamps ? sm.counts() + a : nullptr, changed);
      if (a < 2) grid.sync();
      else more = ctt_grid_vote(grid, changed, state, ++stamp);
      ctt_f3_lap(stamps, 1 + a, clock);
    }
    ++r1;
  }

  // -- edge bits: bit d where the sweep-d edge from the previous voxel exists --
  for (long long p = t0; p < n; p += nt) {
    unsigned char bits = 0;
    if (mask[p] && lab[p] == 0) {
      const long long r = p % hw;
      const int z = (int)((p / hw) % g.Z), y = (int)(r / g.W), x = (int)(r % g.W);
      const float a = alt[p], h = hmap[p];
      const float prev[6] = {
          z > 0 ? alt[p - hw] : CTT_BIG, z < g.Z - 1 ? alt[p + hw] : CTT_BIG,
          y > 0 ? alt[p - g.W] : CTT_BIG, y < g.H - 1 ? alt[p + g.W] : CTT_BIG,
          x > 0 ? alt[p - 1] : CTT_BIG,   x < g.W - 1 ? alt[p + 1] : CTT_BIG,
      };
#pragma unroll
      for (int d = 0; d < 6; ++d)
        if (a == fmaxf(prev[d], h)) bits |= (unsigned char)(1 << d);
    }
    eb[p] = bits;
  }
  for (long long p = t0; p < nflags; p += nt) flags[p] = 1;  // every line anew for phase 2
  grid.sync();
  ctt_f3_lap(stamps, 4, clock);

  // -- phase 2: (hops, label) over the optimal-prefix edges ------------------
  int r2 = 0;
  for (bool more = true; more;) {
    int changed = 0;
    for (int a = 0; a < 3; ++a) {
      ctt_f3_axis(Ctt3dAsg{dist, lab, eb, 2 * a}, g, a, sm, fl,
                  stamps ? sm.counts() + 3 + a : nullptr, changed);
      if (a < 2) grid.sync();
      else more = ctt_grid_vote(grid, changed, state, ++stamp);
      ctt_f3_lap(stamps, 5 + a, clock);
    }
    ++r2;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[1] = r1;
    state[2] = r2;
  }
  if (stamps != nullptr) {
    __syncthreads();
    if (threadIdx.x < 6)
      atomicAdd(reinterpret_cast<unsigned long long*>(stamps) + 8 + threadIdx.x,
                (unsigned long long)sm.counts()[threadIdx.x]);
  }
}
