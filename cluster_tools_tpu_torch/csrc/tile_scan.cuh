// Line sweeps of one tile held in a CTA's shared memory, as warp scans: the
// layout, the sweeps and the line bookkeeping shared by kernel 3
// (flood3d.cuh, ctt_flood_tiles_warm_kernel) and kernel 5 (cc.cuh,
// ctt_cc_tiles_kernel).
//
// Layout.  One CTA per (slice, th x tw tile); each field of the tile in
// shared memory with scan.cuh's swizzled layout at the tile's width: row
// stride S = tw + tw/32 made odd, element (r, j) at r*S + j + j/32.
// Ragged edge tiles (H % th or W % tw nonzero) keep the full tile's layout
// and line cuts, with identity transfers past the line's end.
//
// Sweeps.  A Gauss-Seidel sweep along a line is a chain of transfers of
// the incoming carry (scan.cuh: CttAltOp, CttCcOp), exact under
// composition, so a scan leaves what the sequential sweep leaves.  A line
// of nominal length n is swept by a group of L lanes (scan.cuh:
// ctt_group_lanes(n, CTT_TS_RUN); 8 for a row of 128, 4 for a column of
// 64): lane q holds the run [q*E, q*E + E) of each segment of L*E
// elements, E a power of two of at most CTT_TS_RUN, so a run never
// straddles a swizzle word and its elements sit at i0 + e*d (d = 1 in a
// row, S in a column).  Each lane composes its run, the group scans the
// runs with shuffles (forward in lane order, backward in reverse lane
// order), each lane applies its exclusive prefix to the carry and walks
// its run.  A line of one segment (every line of a tile of at most 128 x
// 128 at CTT_TS_RUN = 16) is loaded into registers once and both sweeps
// run at once: forward then backward leaves at each element the lesser of
// the forward sweep's value and a backward sweep's of the original values
// (for both families a path that passes an element and comes back never
// has a lower maximum, nor a lower minimum label), so the two scans and
// the two walks are independent chains; the changed elements are stored
// once.  A longer line goes segment by segment, the carry passed on,
// forward then backward.
//
// Skipping.  A line swept both ways is at its one-dimensional fixpoint
// until another axis changes one of its elements, so a round sweeps only
// the lines that can change, as the 3d flood does: each row and column
// has a round stamp (dirty in round rr when at least rr); a change by the
// rows marks its column for the same round, a change by the columns (or
// by kernel 5's pointer jump) its row (and column) for the next.  A
// skipped line would have changed nothing, so every round leaves what the
// four sequential sweeps leave and the rounds are theirs.  Each axis
// starts by listing its dirty lines in shared memory (a ballot and one
// atomicAdd per warp), and the CTA's groups take them in turn, so the
// warps share the work whatever lines are dirty.
//
// What bounds a tile on an H100: not bytes (loaded once, stored once), but
// the warps' dependent chains of shuffles and shared-memory steps, times
// the rounds: per line a load, two composes of E, log2(L) shuffle steps of
// each scan and two walks of E, over the dirty lines.
#pragma once

#include "scan.cuh"

#define CTT_TS_RUN 16  // most elements of a line one lane holds: 8 runs cover 128
static_assert((CTT_TS_RUN & (CTT_TS_RUN - 1)) == 0 && CTT_TS_RUN <= 32,
              "runs are powers of two that never straddle a swizzle word");
#define CTT_TILE_STAMPS 5  // ns per tile: load, rows, columns, jump, store

// Elements of one tile field, rounded up to 16 elements.
__host__ __device__ inline size_t ctt_tile_elems(int th, int tw) {
  return ((size_t)th * ctt_band_stride(tw) + 15) & ~(size_t)15;
}
// Ints of a tile's line bookkeeping (ctt_tile_stamp), rounded up to 4.
__host__ __device__ inline size_t ctt_tile_book_ints(int th, int tw) {
  return (2 * ((size_t)th + tw) + 2 + 3) & ~(size_t)3;
}
// A lane's run: the fewest elements (a power of two, at most CTT_TS_RUN)
// whose L runs cover the line.
__host__ __device__ inline int ctt_tile_run(int n, int L) {
  int e = 1;
  while (e < CTT_TS_RUN && e * L < n) e <<= 1;
  return e;
}

// The lines' bookkeeping in shared memory (`book`, zero at the start): the
// round stamps of the th rows and the tw columns, the list of each axis'
// dirty lines in the same order, then the two lists' lengths.
__device__ inline int* ctt_tile_stamp(int* book, int th, bool row) {
  return book + (row ? 0 : th);
}
__device__ inline int* ctt_tile_list(int* book, int th, int tw, bool row) {
  return book + th + tw + (row ? 0 : th);
}
__device__ inline int* ctt_tile_count(int* book, int th, int tw, bool row) {
  return book + 2 * (th + tw) + (row ? 0 : 1);
}

// A lane's run: the transfers of the line's elements k0 + e, e < nr real
// (nr <= E), at shared-memory index i0 + e*d; the rest the identity.
template <class Op>
__device__ inline void ctt_tile_load(const Op& op, typename Op::F (&f)[CTT_TS_RUN], int i0,
                                     int d, int nr) {
#pragma unroll
  for (int e = 0; e < CTT_TS_RUN; ++e) f[e] = e < nr ? op.load(i0 + e * d) : Op::identity();
}

// Stores v at index i where it is below the old value, marking mark[k] =
// stamp.
template <class Op>
__device__ inline void ctt_tile_store(const Op& op, int i, typename Op::V v, typename Op::V old,
                                      int* mark, int k, int stamp, int& changed) {
  if (v < old) {
    op.store(i, v);
    mark[k] = stamp;
    changed = 1;
  }
}

// Both sweeps of a line of one segment at once (see the notes above),
// storing the run's elements that fell.
template <class Op, int L>
__device__ inline void ctt_tile_both(const Op& op, const typename Op::F (&f)[CTT_TS_RUN], int i0,
                                     int d, int k0, int nr, int q, int* mark, int stamp,
                                     int& changed) {
  typedef typename Op::F F;
  typedef typename Op::V V;
  F af = Op::identity(), ab = Op::identity();
#pragma unroll
  for (int e = 0; e < CTT_TS_RUN; ++e) {
    af = Op::compose(af, f[e]);
    ab = Op::compose(ab, f[CTT_TS_RUN - 1 - e]);
  }
  if (L > 1) {  // both scans in one loop: independent chains
#pragma unroll
    for (int s = 1; s < L; s <<= 1) {
      const F of = Op::shfl_up(af, s, L), ob = Op::shfl_down(ab, s, L);
      if (q >= s) af = Op::compose(of, af);
      if (q + s < L) ab = Op::compose(ob, ab);
    }
    const F ef = Op::shfl_up(af, 1, L), eb = Op::shfl_down(ab, 1, L);
    af = q == 0 ? Op::identity() : ef;
    ab = q == L - 1 ? Op::identity() : eb;
  } else {
    af = ab = Op::identity();
  }
  V cf = Op::apply(af, Op::init()), cb = Op::apply(ab, Op::init());
  V vf[CTT_TS_RUN];
#pragma unroll
  for (int e = 0; e < CTT_TS_RUN; ++e) vf[e] = cf = Op::apply(f[e], cf);
#pragma unroll
  for (int e = CTT_TS_RUN - 1; e >= 0; --e) {
    cb = Op::apply(f[e], cb);
    if (e < nr)
      ctt_tile_store(op, i0 + e * d, vf[e] < cb ? vf[e] : cb, f[e].u, mark, k0 + e, stamp,
                     changed);
  }
}

// One sweep of one segment of a longer line, forward or backward (REV),
// from `carry`: compose the run, scan the runs, walk the run and store what
// fell.  Returns the carry out of the segment.
template <class Op, int L, bool REV>
__device__ inline typename Op::V ctt_tile_pass(const Op& op, const typename Op::F (&f)[CTT_TS_RUN],
                                               int i0, int d, int k0, int nr, int q,
                                               typename Op::V carry, int* mark, int stamp,
                                               int& changed) {
  typename Op::F acc = Op::identity();
#pragma unroll
  for (int e = 0; e < CTT_TS_RUN; ++e) acc = Op::compose(acc, f[REV ? CTT_TS_RUN - 1 - e : e]);
  typename Op::V c = Op::apply(ctt_group_exclusive<Op>(acc, q, L, REV), carry);
#pragma unroll
  for (int i = 0; i < CTT_TS_RUN; ++i) {
    const int e = REV ? CTT_TS_RUN - 1 - i : i;
    c = Op::apply(f[e], c);
    if (e < nr) ctt_tile_store(op, i0 + e * d, c, f[e].u, mark, k0 + e, stamp, changed);
  }
  return Op::shfl_v(c, REV ? 0 : L - 1, L);
}

// Both sweeps, forward then backward, of line `line` of a tile field (a row
// if ROW, else a column; row stride S) by a group of L lanes, nominal
// length n, m <= n of its elements real (m = 0 for a group with no line).
// A change at element k marks mark[k] = stamp.  Every lane of the warp
// must call it with the same n.
template <class Op, bool ROW, int L>
__device__ inline void ctt_tile_line_of(const Op& op, int line, int S, int n, int m, int q,
                                        int* mark, int stamp, int& changed) {
  const int E = ctt_tile_run(n, L), seg = L * E, nseg = (n + seg - 1) / seg;
  const int d = ROW ? 1 : S;
  auto at = [&](int k) { return ROW ? line * S + ctt_swz(k) : k * S + ctt_swz(line); };
  auto real = [&](int k) { return max(0, min(E, m - k)); };
  typename Op::F f[CTT_TS_RUN];
  if (nseg == 1) {
    const int k0 = q * E, nr = real(k0), i0 = at(k0);
    ctt_tile_load(op, f, i0, d, nr);
    ctt_tile_both<Op, L>(op, f, i0, d, k0, nr, q, mark, stamp, changed);
    return;
  }
  typename Op::V carry = Op::init();
  for (int s = 0; s < nseg; ++s) {
    const int k0 = s * seg + q * E, nr = real(k0), i0 = at(k0);
    ctt_tile_load(op, f, i0, d, nr);
    carry = ctt_tile_pass<Op, L, false>(op, f, i0, d, k0, nr, q, carry, mark, stamp, changed);
  }
  carry = Op::init();
  for (int s = nseg - 1; s >= 0; --s) {
    const int k0 = s * seg + q * E, nr = real(k0), i0 = at(k0);
    ctt_tile_load(op, f, i0, d, nr);
    carry = ctt_tile_pass<Op, L, true>(op, f, i0, d, k0, nr, q, carry, mark, stamp, changed);
  }
}

// ctt_tile_line_of for the group width L = ctt_group_lanes(n, CTT_TS_RUN),
// the same for the whole CTA: the scans unroll for each width.
template <class Op, bool ROW>
__device__ inline void ctt_tile_line(const Op& op, int line, int S, int n, int m, int q, int L,
                                     int* mark, int stamp, int& changed) {
  switch (L) {
    case 32: ctt_tile_line_of<Op, ROW, 32>(op, line, S, n, m, q, mark, stamp, changed); break;
    case 16: ctt_tile_line_of<Op, ROW, 16>(op, line, S, n, m, q, mark, stamp, changed); break;
    case 8: ctt_tile_line_of<Op, ROW, 8>(op, line, S, n, m, q, mark, stamp, changed); break;
    case 4: ctt_tile_line_of<Op, ROW, 4>(op, line, S, n, m, q, mark, stamp, changed); break;
    case 2: ctt_tile_line_of<Op, ROW, 2>(op, line, S, n, m, q, mark, stamp, changed); break;
    default: ctt_tile_line_of<Op, ROW, 1>(op, line, S, n, m, q, mark, stamp, changed);
  }
}

// Both sweeps of every line of one axis (rows if ROW) of a tile of hh x ww
// real elements (nominal th x tw, row stride S) that can change in round
// rr: the axis' dirty lines are listed (then a barrier), and the CTA's
// groups take them in turn.  Also zeroes the other axis' count, read
// before the barrier that precedes this call.  Every thread of the CTA
// must call it; it ends without a barrier.
template <class Op, bool ROW>
__device__ inline void ctt_tile_axis(const Op& op, int* book, int S, int th, int tw, int hh,
                                     int ww, int rr, int& changed) {
  const int nl = ROW ? hh : ww, n = ROW ? tw : th, m = ROW ? ww : hh;
  const int* stamp = ctt_tile_stamp(book, th, ROW);
  int* list = ctt_tile_list(book, th, tw, ROW);
  int* mark = ctt_tile_stamp(book, th, !ROW);
  int* count = ctt_tile_count(book, th, tw, ROW);
  const int lane = threadIdx.x & 31, L = ctt_group_lanes(n, CTT_TS_RUN);
  const int q = threadIdx.x & (L - 1);
  if (threadIdx.x == 0) *ctt_tile_count(book, th, tw, !ROW) = 0;
  for (int i0 = threadIdx.x & ~31; i0 < nl; i0 += blockDim.x) {
    const int i = i0 + lane;
    const bool dirty = i < nl && stamp[i] >= rr;
    const unsigned b = __ballot_sync(~0u, dirty);
    int at = 0;
    if (lane == 0 && b) at = atomicAdd(count, __popc(b));
    at = __shfl_sync(~0u, at, 0);
    if (dirty) list[at + __popc(b & ((1u << lane) - 1))] = i;
  }
  __syncthreads();
  const int total = *count;
  for (int k0 = 0; k0 < total; k0 += blockDim.x / L) {
    const int k = k0 + threadIdx.x / L, line = k < total ? list[k] : 0;
    ctt_tile_line<Op, ROW>(op, line, S, n, k < total ? m : 0, q, L, mark, ROW ? rr : rr + 1,
                           changed);
  }
}

// The tile of CTA blockIdx.x in a grid of N * gh * gw tiles (slice-major,
// then tile row, tile column).
struct CttTile {
  int s, r0, c0, hh, ww;
};
__device__ inline CttTile ctt_tile_of(int H, int W, int th, int tw, int gh, int gw) {
  int t = blockIdx.x;
  const int tx = t % gw;
  t /= gw;
  const int ty = t % gh;
  CttTile g;
  g.s = t / gh;
  g.r0 = ty * th;
  g.c0 = tx * tw;
  g.hh = min(th, H - g.r0);
  g.ww = min(tw, W - g.c0);
  return g;
}

// Phase times of one tile (ON: stamps holds CTT_TILE_STAMPS int64 in ns):
// thread 0 adds the card's clock (%globaltimer) since its last lap.  With
// ON false it compiles to nothing, so a kernel without stamps pays no
// register for it.
template <bool ON>
struct CttTileTimer {
  long long* out;
  long long t;
  __device__ static long long now() {
    unsigned long long v;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
    return (long long)v;
  }
  __device__ explicit CttTileTimer(long long* stamps) : out(stamps), t(0) {
    if (ON && threadIdx.x == 0) {
      for (int k = 0; k < CTT_TILE_STAMPS; ++k) out[k] = 0;
      t = now();
    }
  }
  __device__ void lap(int k) {
    if (ON && threadIdx.x == 0) {
      const long long v = now();
      out[k] += v - t;
      t = v;
    }
  }
};
