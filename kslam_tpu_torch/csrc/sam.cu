// The SAM path's kernels: sam_cigar (the cigar of each SAM alignment, as
// the native host call kslam_ssw_cigar_batch in csrc/ssw_batch.cc
// computes it for one overlap), its long-read path sam_cigar_long, and
// sam_diff (io/sam.py's get_cigar_and_md: the CIGAR and MD texts, NM and
// the log10 probability).  Glue, checks and plain versions:
// ops/sam_cuda.py.
//
// They replace host work, not a Pallas kernel: ssw_batch.cc:229-345
// (OpenMP) and the per-base Python loop of io/sam.py:40-121.
//
// What bounds them on the H100.  sam_cigar is integer work: the forward
// pass and the reverse pass over the reversed prefixes are ~2 x 150 x 150
// cells an alignment, ~99% of its cells; the banded DP is a few cells a
// row, the traceback a few hundred steps.  sam_diff reads a read, its
// quality and a reference window and writes two short texts: bytes, and a
// float64 sum that must stay a sequential chain.
//
// sam_cigar: two kernels a batch.
// * sam_pass_kernel, one group of G lanes an alignment.  The block stages
//   its alignments' native windows as score words in shared memory (the
//   SW code table applied, complemented and reversed for rc), one warp a
//   window, and finds each window's first and last non-N column as it
//   stages.  The forward pass and the reverse pass over the reversed
//   prefixes are sw_align's register wavefront (sw_group.cuh's
//   group_pass: R query rows a lane, __shfl_up_sync between rows, DPX max
//   ops, the packed key whose order is the native's tie-break: max score,
//   then the smallest column, then the smallest row).  With gap_open >=
//   gap_extend the wavefront's F (from h' before F) equals the native's
//   (from H after F); the wrapper sends any other parameters to
//   sam_cigar_long.
// * sam_band_kernel, a group of 8 lanes an alignment: the banded DP with
//   each band row's cells spread over the lanes (E and the diagonal from
//   the row above, F an exclusive max-plus scan along the row), its three
//   band rows and direction bytes (one packed byte a band cell: bit 0 E's
//   3 over 2, bit 1 F's 5 over 4, bits 2-4 H's 1..5; 0 never written) in
//   the group's region of shared memory, read back by the traceback on
//   the group's lane 0 at the native's flat index, so that a traceback
//   leaving its band row reads what the native reads.  Each attempt
//   zeroes its part of the region with 16 B stores.  The warp's four
//   groups run in lockstep (loops to the warp's largest counts): groups
//   that drift apart serialize.  A separate kernel: the band is
//   latency-bound and needs many alignments in flight, while the passes'
//   blocks hold their score words and registers; in one kernel a block
//   waited on its slowest alignment's band.  A band wider than the region
//   holds (w_cap), or a cigar longer than its row, writes REDO (REDO_OPS);
//   the wrapper takes those rows with one nonzero and runs the band
//   kernel again on them alone (kSlab): a warp an alignment, its region
//   in device memory for any band, the attempts the first launch made
//   skipped.
// * Limits: reads' stride and windows <= 1024 and match * stride <= 2047
//   (the key's fields).  Past them the wrapper launches sam_cigar_long:
//   one thread an alignment, the native code's loops in its order, H and
//   E columns in shared memory interleaved by thread, band rows and
//   direction bytes in device slabs.
//
// sam_diff: one lane an alignment, a warp a block.  Each lane stages its
// read, quality and reference window into shared memory (16 B loads
// where the rows allow them); the warp's lanes walk their cigars in
// lockstep, a base or a run's start a round: the compare, the float64
// log10 chain in the walk's order (__dadd_rn), NM, and the MD state
// machine's calls queued at the mismatches and deletions only, replayed
// in order when a queue may fill and at the end; then the CIGAR text, a
// run a round; the warp stores the texts as 16 B words.  Lanes, not a
// warp an alignment: the walk's serial steps (the chain, the state
// machine, the texts) cost a warp an instruction for each alignment
// where 32 lanes share one; a warp an alignment (32 bases a round,
// mismatches by __ballot_sync, NM by __popc, the chain over terms in
// shared memory) was timed slower on the card (PERF.md, section 6).
//
// Exactness: every comparison, tie and quirk of ssw_batch.cc is kept as
// written (the band arrays' edge and row-0 zeroing, E read in place, the
// last non-empty row's length carried into the copy, the merged leading
// M, the run-count abort); the float64 probability is summed with
// __dadd_rn, in the walk's order, from the walk's own tables.

#include <climits>
#include <cstdint>

#include "device_guard.cuh"
#include "sw_group.cuh"

namespace {

using namespace kslam;

constexpr int kAborted = -1;
constexpr int kFiltered = -2;
constexpr int kRedo = -3;                     // the band outgrew w_cap
constexpr int kRedoOps = -5;                  // the runs outgrew ops_cap
constexpr long long kWidthLimit = 1ll << 31;  // ssw.c:631-642
constexpr int kGroupThreads = 128;  // sam_cigar's passes: block, at most
constexpr int kBandWarps = 2;       // sam_cigar's band: warps a block
constexpr int kDiffEvents = 32;    // sam_diff: queued MD calls a lane
constexpr int kEvNumber = 0, kEvLetter = 1, kEvDelBegin = 2, kEvDelChar = 3,
              kEvDelEnd = 4;        // sam_diff: the MD state machine's calls

struct Sw {
  int match, mismatch, go, ge;
};

__device__ __forceinline__ int sub_score(int q, int r, const Sw& p) {
  return (q == 4 || r == 4) ? 0 : (q == r ? p.match : -p.mismatch);
}

__device__ __forceinline__ int comp5(int c) { return c < 4 ? c ^ 2 : c; }

__host__ __device__ __forceinline__ int band_ints(int w_cap) {
  return 2 * w_cap + 5 > 8 ? 2 * w_cap + 5 : 8;
}

struct Ends {
  int score, ref_end, read_end;
};

// sw_forward_ends (ssw_batch.cc:58-97) of the query rows q(0..m) against
// the ref columns r(0..n); H and E: this thread's shared columns, stride T.
template <class Q, class R>
__device__ Ends forward_ends(Q q, int m, R r, int n, const Sw& p, int* H,
                             int* E, int T) {
  if (m == 0 || n == 0) return {0, -1, 0};
  for (int i = 0; i < m; ++i) {
    H[i * T] = 0;
    E[i * T] = 0;
  }
  const int neg = INT_MIN / 4;
  int best = 0, best_col = -1, best_row = 0;
  for (int j = 0; j < n; ++j) {
    const int rj = r(j);
    int diag = 0, f = neg, colmax = 0, colrow = 0;
    for (int i = 0; i < m; ++i) {
      const int hprev = H[i * T];
      int h = diag + sub_score(q(i), rj, p);
      if (h < 0) h = 0;
      const int e = E[i * T];
      if (e > h) h = e;
      if (f > h) h = f;
      int en = h - p.go;
      const int e2 = e - p.ge;
      if (e2 > en) en = e2;
      if (en < 0) en = 0;
      E[i * T] = en;
      const int fn = h - p.go;
      const int f2 = f - p.ge;
      f = f2 > fn ? f2 : fn;
      H[i * T] = h;
      diag = hprev;
      if (h > colmax) {
        colmax = h;
        colrow = i;
      }
    }
    if (colmax > best) {
      best = colmax;
      best_col = j;
      best_row = colrow;
    }
  }
  if (best == 0) return {0, -1, 0};
  return {best, best_col, best_row};
}

__device__ __forceinline__ int decode_dir(uint8_t cell, int layer) {
  if (cell == 0) return 0;
  if (layer == 0) return (cell & 1) ? 3 : 2;
  if (layer == 1) return (cell & 2) ? 5 : 4;
  return cell >> 2;
}

// One attempt of banded_cigar's DP (ssw_batch.cc:104-158) at band w:
// rd(i) the read code of row i of the [begin..end] sub-sequence, sub(c, j)
// the score of read code c against ref column j.  hb/eb/hc: the band rows
// (zeroed, >= max(2 w + 5, 8) ints each); dir: the direction bytes
// (zeroed, >= read_len * (2 w + 1)).  Returns the DP's max.  hc[b], the
// cell to the left, is carried in a register: it is 0 (hc[0]) at a
// row's first cell and the cell just written after it.
template <class RD, class SUB>
__device__ int band_dp(RD rd, SUB sub, int read_len, int ref_len,
                       const Sw& p, int w, int* hb, int* eb, int* hc,
                       uint8_t* dir) {
  const int width = 2 * w + 3;
  const int width_d = 2 * w + 1;  // width_d * read_len * 3 < 2^31: checked
  int max_score = 0;
  int u = 0;
  for (int i = 0; i < read_len; ++i) {
    const int beg = i - w > 0 ? i - w : 0;
    const int end = i + w < ref_len - 1 ? i + w : ref_len - 1;
    const int edge = end + 1 < width - 1 ? end + 1 : width - 1;
    int f = 0, h_left = 0;
    hb[0] = eb[0] = hb[edge] = eb[edge] = hc[0] = 0;
    uint8_t* dline = dir + i * width_d;
    const int x_i = beg;
    const int x_im1 = i - 1 - w > 0 ? i - 1 - w : 0;
    const int rdi = rd(i);
    for (int j = beg; j <= end; ++j) {
      u = j - x_i + 1;
      const int e_idx = j - x_im1 + 1;
      const int d = j - 1 - x_im1 + 1;
      int t1 = i == 0 ? -p.go : hb[e_idx] - p.go;
      int t2 = i == 0 ? -p.ge : eb[e_idx] - p.ge;
      const int e_new = t1 > t2 ? t1 : t2;
      const int d0 = t1 > t2 ? 3 : 2;
      t1 = h_left - p.go;
      t2 = f - p.ge;
      f = t1 > t2 ? t1 : t2;
      const int d1 = t1 > t2 ? 5 : 4;
      const int e1 = e_new > 0 ? e_new : 0;
      const int f1 = f > 0 ? f : 0;
      t1 = e1 > f1 ? e1 : f1;
      t2 = hb[d] + sub(rdi, j);
      eb[u] = e_new;
      const int h = t1 > t2 ? t1 : t2;
      hc[u] = h;
      h_left = h;
      if (h > max_score) max_score = h;
      const int d2 = t1 <= t2 ? 1 : (e1 > f1 ? d0 : d1);
      dline[j - x_i] = (uint8_t)((d0 == 3) | ((d1 == 5) << 1) | (d2 << 2));
    }
    for (int k = 1; k <= u; ++k) hb[k] = hc[k];
  }
  return max_score;
}

// The traceback (ssw_batch.cc:160-200) over the direction bytes of the
// band that reached the score: runs in traceback order to out (ops_cap of
// them at most); returns their count, kAborted, or kRedoOps when the runs
// outgrow ops_cap.
__device__ int traceback(const uint8_t* dir, int read_len, int ref_len,
                         int band_width, int* out, int ops_cap,
                         int max_ops) {
  const long long width_d = 2ll * band_width + 1;
  const long long total = (long long)read_len * width_d * 3;
  int n_runs = 0;
  int i = read_len - 1, j = ref_len - 1;
  int e = 0, f = 0, run_op = 0, temp2 = 2;
  while (i > 0) {
    const int x = i - band_width > 0 ? i - band_width : 0;
    const long long idx = (long long)i * width_d * 3 +
                          (long long)(j - x) * 3 + temp2;
    // outside the slab the native reads outside its vector
    if (idx < 0 || idx >= total) return kAborted;
    const unsigned ix = static_cast<unsigned>(idx);  // < 2^31: checked
    switch (decode_dir(dir[ix / 3u], (int)(ix % 3u))) {
      case 1: --i; --j; temp2 = 2; f = 0; break;
      case 2: --i; temp2 = 0; f = 1; break;
      case 3: --i; temp2 = 2; f = 1; break;
      case 4: --j; temp2 = 1; f = 2; break;
      case 5: --j; temp2 = 2; f = 2; break;
      default: return kAborted;  // "trace back error"
    }
    if (f == run_op) {
      ++e;
    } else {
      if (n_runs >= 4094) return kAborted;
      if (n_runs < ops_cap) out[n_runs] = (e << 4) | run_op;
      ++n_runs;
      run_op = f;
      e = 1;
    }
  }
  if (f == 0) {
    if (n_runs < ops_cap) out[n_runs] = (e + 1) << 4;  // merged leading M
    ++n_runs;
  } else {
    if (n_runs < ops_cap) out[n_runs] = (e << 4) | f;
    ++n_runs;
    if (n_runs < ops_cap) out[n_runs] = 1 << 4;
    ++n_runs;
  }
  if (n_runs > max_ops) return kAborted;
  if (n_runs > ops_cap) return kRedoOps;
  return n_runs;
}

// --- sam_cigar: the two passes, one group an alignment ------------------

// Group of G = 2^log_g lanes an alignment k < n, R query rows a lane
// (G * R >= the reads' stride).  Dynamic shared memory: [per_block]
// [col_stride] score words, [per_block][2] column extents, the SW code
// table (256 B).  Writes score and the ends (entry coordinates, as
// sam_cigar reports them) and cigar_len FILTERED; the band kernel then
// writes the cigars.
template <int R, bool kByte>
__global__ void __launch_bounds__(kGroupThreads) sam_pass_kernel(
    const uint8_t* __restrict__ reads, const int* __restrict__ read_len,
    long long stride, const uint8_t* __restrict__ tab,
    const uint8_t* __restrict__ win, const int* __restrict__ wlen,
    long long win_stride, const int* __restrict__ read_id,
    const uint8_t* __restrict__ rc, const int* __restrict__ ref_start,
    long long n, Sw sw, int* score, int* ref_begin, int* ref_end,
    int* query_begin, int* query_end, int* cigar_len, int log_g,
    int col_stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = 1 << log_g;
  const int per_block = blockDim.x >> log_g;
  uint32_t* cols = reinterpret_cast<uint32_t*>(smem);
  int* extents = reinterpret_cast<int*>(cols + per_block * col_stride);
  uint8_t* tab_s = reinterpret_cast<uint8_t*>(extents + 2 * per_block);
  const long long a0 = (long long)blockIdx.x * per_block;
  const int n_here = (int)(n - a0 < per_block ? n - a0 : per_block);
  const uint32_t mm_rep = (static_cast<uint32_t>(-sw.mismatch) & 0xFFu) *
                          0x01010101u;
  const uint32_t match_b = static_cast<uint32_t>(sw.match) & 0xFFu;

  for (int c = threadIdx.x; c < 256; c += blockDim.x) tab_s[c] = tab[c];
  __syncthreads();
  // stage the windows: one warp a window, a byte a lane
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    for (int a = warp; a < n_here; a += n_warps) {  // uniform in the warp
      const long long k = a0 + a;
      const int wl = wlen[k];
      const bool is_rc = rc[k] != 0;
      const uint8_t* wrow = win + k * win_stride;
      uint32_t* dst = cols + a * col_stride;
      int lo = wl, hi = -1;                     // this lane's non-N extent
      for (int j = lane; j < wl; j += 32) {
        const int c = is_rc ? comp5(tab_s[wrow[wl - 1 - j]]) : tab_s[wrow[j]];
        dst[j] = column_word<kByte>(c, mm_rep, match_b);
        if (c < 4) {
          lo = min(lo, j);
          hi = max(hi, j);
        }
      }
      lo = __reduce_min_sync(0xFFFFFFFFu, lo);
      hi = __reduce_max_sync(0xFFFFFFFFu, hi);
      if (lane == 0) {
        extents[2 * a] = lo;
        extents[2 * a + 1] = hi;
      }
    }
  }
  __syncthreads();

  const int slot = threadIdx.x >> log_g;
  const int p = threadIdx.x & (g - 1);
  const long long k = a0 + slot;
  if (k >= n) return;                           // whole groups only
  const unsigned mask = group_mask(g);
  const int rid = read_id[k];
  const int m = read_len[rid];
  const uint8_t* row = reads + (long long)rid * stride;
  const int wl = wlen[k];
  const uint32_t* my_cols = cols + slot * col_stride;
  int sc = 0, rb = 0, re = 0, qb = 0, qe = 0;
  if (m > 0) {                                  // uniform in the group
    uint32_t sel[R];
    int h[R], e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = p * R + r;
      sel[r] = selector<kByte>(i < m ? tab_s[row[i]] : 4);
      h[r] = 0;
      e[r] = 0;
    }
    const int c0 = extents[2 * slot];
    const KeyEnds fwd = decode(group_pass<R, kByte, 1>(
        my_cols + c0, c0, extents[2 * slot + 1] - c0 + 1, g, sel, h, e, p,
        g, mask, sw.match, sw.mismatch, sw.go, sw.ge));
    sc = fwd.score;
    re = fwd.col;
    qe = fwd.row;
    int re2 = 0, rd2 = 0;
    if (fwd.score > 0) {
      // reverse row i' = p*R + r holds query row read_end - i'
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = p * R + r;
        sel[r] = selector<kByte>(i <= fwd.row ? tab_s[row[fwd.row - i]] : 4);
        h[r] = 0;
        e[r] = 0;
      }
      const KeyEnds rev = decode(group_pass<R, kByte, -1>(
          my_cols + fwd.col, 0, fwd.col - c0 + 1, (fwd.row + R) / R, sel, h,
          e, p, g, mask, sw.match, sw.mismatch, sw.go, sw.ge));
      if (rev.col >= 0) {
        re2 = rev.col;
        rd2 = rev.row;
      }
    }
    rb = re - re2;
    qb = qe - rd2;
  }
  if (p != 0) return;
  if (rc[k] != 0) {
    const int rb2 = wl - (re + 1), re_2 = wl - (rb + 1);
    const int qb2 = m - (qe + 1), qe2 = m - (qb + 1);
    rb = rb2;
    re = re_2;
    qb = qb2;
    qe = qe2;
  }
  score[k] = sc;
  ref_begin[k] = rb + ref_start[k];
  ref_end[k] = re + ref_start[k];
  query_begin[k] = qb;
  query_end[k] = qe;
  cigar_len[k] = kFiltered;
}

// --- sam_cigar: the band and the traceback, one warp an alignment -------

// One attempt of banded_cigar's DP (ssw_batch.cc:104-158) at band w by a
// group of LB lanes (lane gl), for the groups of the warp that are
// `live`: each band row's cells are spread over the group's lanes, LB at
// a time.  The warp runs in lockstep: rows, chunks and copies go to the
// warp's largest counts, a group past its own only takes part in the
// shuffles (lanes that drift apart serialize).  E and the diagonal come
// from the previous row; F along the row is an exclusive max-plus scan
// (f_k = max(-(k+1) ge, max_{l<k}(h0_l + l ge) - go - (k-1) ge), with h0
// the cell's H before F: exact for gap_open >= gap_extend, as the plain
// version takes it).  The band rows' quirks are kept: reads at the row's
// edge index see 0 (and the arrays keep that 0 where no write of the row
// covers it), E is the previous row's at every read (a chunk writes
// eb[u] only after it has read eb[u + s], and later chunks read past
// it), the copy into hb covers the last non-empty row's length.  qc: the
// sub-read's codes, rcd: the sub-window's codes.  Returns the DP's max
// on the group's lanes.
template <int LB>
__device__ int lockstep_band_dp(const uint8_t* qc, int read_len,
                                const uint8_t* rcd, int ref_len,
                                const Sw& sw, int w, int* hb, int* eb,
                                int* hc, uint8_t* dir, int gl, bool live) {
  const unsigned full = 0xFFFFFFFFu;
  const int width = 2 * w + 3;
  const int width_d = 2 * w + 1;
  const int rows = live ? read_len : 0;
  const int rows_max = __reduce_max_sync(full, rows);
  int max_score = 0, u_last = 0;
  for (int i = 0; i < rows_max; ++i) {
    const bool on = i < rows;
    const int beg = i - w > 0 ? i - w : 0;
    const int end = i + w < ref_len - 1 ? i + w : ref_len - 1;
    const int edge = end + 1 < width - 1 ? end + 1 : width - 1;
    const int n_cells = on && end - beg + 1 > 0 ? end - beg + 1 : 0;
    const int s = beg - (i - 1 - w > 0 ? i - 1 - w : 0);   // x_i - x_im1
    const int qi = on ? qc[i] : 4;
    uint8_t* dline = dir + i * width_d;
    const int chunks = __reduce_max_sync(full, (n_cells + LB - 1) / LB);
    int carry_a = -sw.ge;       // max of h0_l + l ge over earlier chunks
    int carry_h = 0, carry_f = 0;   // H and F of the cell before the chunk
    for (int c = 0; c < chunks; ++c) {
      const int k = c * LB + gl;
      const bool valid = k < n_cells;
      const int u = k + 1;
      const int ei = u + s, d = ei - 1;
      int e_new = 0, d0 = 0, e1 = 0, t2d = 0, h0 = 0;
      if (valid) {
        const int hbe = ei == edge ? 0 : hb[ei];
        const int ebe = ei == edge ? 0 : eb[ei];
        const int hbd = d == edge ? 0 : hb[d];
        const int t1 = i == 0 ? -sw.go : hbe - sw.go;
        const int t2 = i == 0 ? -sw.ge : ebe - sw.ge;
        e_new = t1 > t2 ? t1 : t2;
        d0 = t1 > t2;
        e1 = e_new > 0 ? e_new : 0;
        t2d = hbd + sub_score(qi, rcd[beg + k], sw);
        h0 = e1 > t2d ? e1 : t2d;
      }
      int incl = valid ? h0 + k * sw.ge : INT_MIN / 2;
#pragma unroll
      for (int o = 1; o < LB; o <<= 1) {
        const int v = __shfl_up_sync(full, incl, o, LB);
        if (gl >= o) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(full, incl, 1, LB);
      excl = gl == 0 ? carry_a : max(carry_a, excl);
      const int f = max(-(k + 1) * sw.ge, excl - sw.go - (k - 1) * sw.ge);
      const int f1 = f > 0 ? f : 0;
      const int h = h0 > f1 ? h0 : f1;
      int hp = __shfl_up_sync(full, h, 1, LB);
      int fp = __shfl_up_sync(full, f, 1, LB);
      if (gl == 0) {
        hp = carry_h;
        fp = carry_f;
      }
      const int d1 = (hp - sw.go) > (fp - sw.ge);
      const int d2 = (e1 > f1 ? e1 : f1) <= t2d
                         ? 1
                         : (e1 > f1 ? (d0 ? 3 : 2) : (d1 ? 5 : 4));
      if (c + 1 < chunks) {     // carries to the row's next chunk
        carry_a = max(carry_a, __shfl_sync(full, incl, LB - 1, LB));
        carry_h = __shfl_sync(full, h, LB - 1, LB);
        carry_f = __shfl_sync(full, f, LB - 1, LB);
      }
      __syncwarp();             // the chunk's reads before its writes
      if (valid) {
        eb[u] = e_new;
        hc[u] = h;
        dline[k] = (uint8_t)(d0 | (d1 << 1) | (d2 << 2));
        if (h > max_score) max_score = h;
      }
    }
    if (n_cells > 0) u_last = n_cells;
    const int n_copy = on ? u_last : 0;
    const int copies = __reduce_max_sync(full, (n_copy + LB - 1) / LB);
    __syncwarp();
    for (int c = 0; c < copies; ++c) {
      const int x = 1 + c * LB + gl;
      if (x <= n_copy) hb[x] = hc[x];
    }
    if (gl == 0 && on) {
      if (edge > n_cells) eb[edge] = 0;
      if (edge > u_last) hb[edge] = 0;
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = LB / 2; o > 0; o >>= 1)
    max_score = max(max_score, __shfl_xor_sync(full, max_score, o, LB));
  return max_score;
}

// banded_cigar (ssw_batch.cc:104-200) by the groups of LB lanes of a
// warp in lockstep (every lane of the warp calls it; a group with
// active false only takes part): each group's band doubles until its DP
// reaches its score; each attempt zeroes the group's band rows and
// direction bytes with 16 B stores; the tracebacks run on the groups'
// lane 0.  Attempts at half-widths up to skip_w are known to fail (an
// earlier launch ran them) and are skipped.  reg: the alignment's
// region, [hb | eb | hc] of band_ints(w_cap) ints each, then the
// direction bytes.  Returns the runs' count, kAborted, kRedo or kRedoOps
// on the group's lane 0.
template <int LB>
__device__ int lockstep_band_cigar(const uint8_t* qc, int read_len,
                                   const uint8_t* rcd, int ref_len,
                                   int score, const Sw& sw, int band_width,
                                   int skip_w, uint8_t* reg, int w_cap,
                                   int* out, int ops_cap, int max_ops,
                                   int gl, bool active) {
  const int hcap = band_ints(w_cap);
  int* hb = reinterpret_cast<int*>(reg);
  int* eb = hb + hcap;
  int* hc = eb + hcap;
  uint8_t* dir = reinterpret_cast<uint8_t*>(hc + hcap);
  while (active && band_width <= skip_w) band_width *= 2;
  int state = active ? 0 : 2;   // 0 doubling, 1 to trace back, 2 done
  int result = 0;
  for (;;) {
    bool live = false;
    if (state == 0) {
      const long long width_d = 2ll * band_width + 1;
      if (width_d * read_len * 3 >= kWidthLimit) {
        result = kAborted;
        state = 2;
      } else if (band_width > w_cap) {
        result = kRedo;
        state = 2;
      } else {
        live = true;
      }
    }
    if (!__any_sync(0xFFFFFFFFu, live)) break;
    if (live) {
      const int words = (12 * hcap + read_len * (2 * band_width + 1) + 15)
                        >> 4;
      uint4* z = reinterpret_cast<uint4*>(reg);
      for (int v = gl; v < words; v += LB) z[v] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    const int best = lockstep_band_dp<LB>(qc, read_len, rcd, ref_len, sw,
                                          band_width, hb, eb, hc, dir, gl,
                                          live);
    if (live) {
      if (best >= score) {
        state = 1;
      } else if (band_width >= read_len - 1 && band_width >= ref_len - 1) {
        // a band over every cell repeats this DP at any width: the
        // native doubles on to its width check and aborts there
        result = kAborted;
        state = 2;
      } else {
        band_width *= 2;
      }
    }
  }
  if (state == 1 && gl == 0)
    result = traceback(dir, read_len, ref_len, band_width, out, ops_cap,
                       max_ops);
  return result;
}

// Groups of LB lanes, an alignment each, after sam_pass_kernel: group t
// < n takes alignment k = rows[t] (t without rows): from its score and
// ends, the band's first width, then banded_cigar on the sub-read and the
// sub-window, staged as codes; its runs go to cigar_buf row t.  Dynamic
// shared memory: the SW code table (256 B), then a slot a group: qpitch
// bytes of read codes, rpitch bytes of window codes, and (unless kSlab)
// the band region of `region` bytes.  kSlab: the regions are slab + t *
// region in device memory, and a row that cigar_len marks kRedo (its band
// outgrew the first launch's w_cap, skip_w) skips the attempts up to
// skip_w.  Writes cigar_len and the runs (forward order for a forward
// hit), and zeroes the score on an abort (ssw.c:941-944).  kSlab also
// zero-fills row t past its runs, copies runs that fit main_cap into
// main_buf row k (zeroed past them), and counts into stats[0] the rows
// still flagged and into stats[1] the most runs of a row.
template <int LB, bool kSlab>
__global__ void __launch_bounds__(32 * kBandWarps) sam_band_kernel(
    const uint8_t* __restrict__ reads, const int* __restrict__ read_len,
    long long stride, const uint8_t* __restrict__ tab,
    const uint8_t* __restrict__ win, const int* __restrict__ wlen,
    long long win_stride, const int* __restrict__ read_id,
    const uint8_t* __restrict__ rc, const int* __restrict__ ref_start,
    long long n, Sw sw, int score_filter, int max_ops, int* score,
    const int* __restrict__ ref_begin, const int* __restrict__ ref_end,
    const int* __restrict__ query_begin, const int* __restrict__ query_end,
    int* cigar_buf, int* cigar_len, int ops_cap, uint8_t* slab, int w_cap,
    int skip_w, int qpitch, int rpitch, int region,
    const long long* __restrict__ rows, int* main_buf, int main_cap,
    int* stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tab_s = smem;
  for (int c = threadIdx.x; c < 256; c += blockDim.x) tab_s[c] = tab[c];
  __syncthreads();
  const int slot_i = threadIdx.x / LB;
  const int gl = threadIdx.x % LB;
  const long long t = (long long)blockIdx.x * (32 * kBandWarps / LB) +
                      slot_i;
  if (((long long)blockIdx.x * (32 * kBandWarps / LB) +
       (threadIdx.x & ~31) / LB) >= n)
    return;                                     // whole warps only
  uint8_t* slot = smem + 256 + slot_i * (qpitch + rpitch +
                                         (kSlab ? 0 : region));
  uint8_t* qc = slot;
  uint8_t* rcd = slot + qpitch;
  // this group's alignment (none past n, empty or filtered)
  int sc = 0, read_sub = 0, ref_n = 0, bw = 1, skip = 0;
  bool is_rc = false, active = false;
  uint8_t* reg = kSlab ? slab : slot + qpitch + rpitch;
  const long long k = t < n ? (rows ? rows[t] : t) : 0;
  const int flag = t < n && kSlab ? cigar_len[k] : 0;
  if (t < n) {
    const int rid = read_id[k];
    const int m = read_len[rid];
    sc = score[k];
    active = m > 0 && !(score_filter && sc < score_filter);  // else FILTERED
    if (active) {
      skip = flag == kRedo ? skip_w : 0;
      if (kSlab) reg = slab + t * (long long)region;
      // the ends back in the window's coordinates
      is_rc = rc[k] != 0;
      const int wl = wlen[k];
      const int rs = ref_start[k];
      const int rb_o = ref_begin[k] - rs, re_o = ref_end[k] - rs;
      const int qb_o = query_begin[k], qe_o = query_end[k];
      const int rb = is_rc ? wl - re_o - 1 : rb_o;
      const int re = is_rc ? wl - rb_o - 1 : re_o;
      const int qb = is_rc ? m - qe_o - 1 : qb_o;
      const int qe = is_rc ? m - qb_o - 1 : qe_o;
      read_sub = qe - qb + 1;
      bw = re - rb + 1 - read_sub;
      bw = (bw < 0 ? -bw : bw) + 1;
      const int rb_c = rb < 0 ? 0 : rb;
      ref_n = re - rb_c + 1 > 0 ? re - rb_c + 1 : 0;
      const uint8_t* row = reads + (long long)rid * stride + qb;
      const uint8_t* wrow = win + k * win_stride;
      for (int i = gl; i < read_sub; i += LB) qc[i] = tab_s[row[i]];
      for (int j = gl; j < ref_n; j += LB) {
        const int col = rb_c + j;
        rcd[j] = is_rc ? comp5(tab_s[wrow[wl - 1 - col]]) : tab_s[wrow[col]];
      }
    }
  }
  __syncwarp();
  int* out = cigar_buf + (t < n ? t : 0) * ops_cap;
  int clen = lockstep_band_cigar<LB>(qc, read_sub, rcd, ref_n, sc, sw, bw,
                                     skip, reg, w_cap, out, ops_cap,
                                     max_ops, gl, active);
  if (!active) return;
  clen = __shfl_sync(group_mask(LB), clen, 0, LB);
  const int have = clen > 0 ? clen : 0;
  const bool fits = clen > kRedo && have <= main_cap;
  if (gl == 0) {
    if (clen == kAborted) {
      score[k] = 0;  // ssw.c:941-944
    } else if (clen >= 0 && !is_rc) {
      // the runs came in traceback order: forward order for a forward
      // hit, and for rc the native's two reversals cancel
      for (int x = 0, y = clen - 1; x < y; ++x, --y) {
        const int tmp = out[x];
        out[x] = out[y];
        out[y] = tmp;
      }
    }
    cigar_len[k] = clen;
    if (kSlab && clen <= kRedo) atomicAdd(stats, 1);
  }
  if (!kSlab) return;
  __syncwarp(group_mask(LB));
  if (clen > kRedo) {
    for (int x = have + gl; x < ops_cap; x += LB) out[x] = 0;
    if (gl == 0) atomicMax(stats + 1, have);
  }
  if (fits) {
    int* row_main = main_buf + k * main_cap;
    for (int x = gl; x < main_cap; x += LB)
      row_main[x] = x < have ? out[x] : 0;
  }
}

// --- sam_cigar_long: one thread an alignment ----------------------------

// banded_cigar (ssw_batch.cc:104-200) on one thread.  hb/eb/hc: this
// alignment's band rows (band_ints(w_cap) ints each); dir: its slab
// (>= read_len * (2 w_cap + 1) bytes).
template <class RD, class RF>
__device__ int banded_cigar(RD rd, int read_len, RF rf, int ref_len,
                            int score, const Sw& p, int band_width, int* hb,
                            int* eb, int* hc, uint8_t* dir, int w_cap,
                            int* out, int ops_cap, int max_ops) {
  auto sub = [&](int c, int j) { return sub_score(c, rf(j), p); };
  for (;;) {
    const int w = band_width;
    const long long width_d = 2ll * w + 1;
    if (width_d * read_len * 3 >= kWidthLimit) return kAborted;
    if (w > w_cap) return kRedo;
    const int hsz = 2 * w + 5 > 8 ? 2 * w + 5 : 8;
    for (int k = 0; k < hsz; ++k) hb[k] = eb[k] = hc[k] = 0;
    for (long long k = 0; k < read_len * width_d; ++k) dir[k] = 0;
    if (band_dp(rd, sub, read_len, ref_len, p, w, hb, eb, hc, dir) >= score)
      break;
    if (w >= read_len - 1 && w >= ref_len - 1) return kAborted;
    band_width *= 2;
  }
  return traceback(dir, read_len, ref_len, band_width, out, ops_cap,
                   max_ops);
}

// One thread an alignment k < n.  Dynamic shared memory: H [qmax][T]
// ints, E [qmax][T] ints, the query's codes [qmax][T] bytes.
__global__ void sam_cigar_long_kernel(
    const uint8_t* __restrict__ reads, const int* __restrict__ read_len,
    long long stride, const uint8_t* __restrict__ tab,
    const uint8_t* __restrict__ win, const int* __restrict__ wlen,
    long long win_stride, const int* __restrict__ read_id,
    const uint8_t* __restrict__ rc, const int* __restrict__ ref_start,
    long long n, Sw p, int score_filter, int max_ops, int* score,
    int* ref_begin, int* ref_end, int* query_begin, int* query_end,
    int* cigar_buf, int* cigar_len, int ops_cap, uint8_t* dir_slab,
    int* band_slab, int w_cap, int qmax) {
  extern __shared__ int smem_long[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long k = (long long)blockIdx.x * T + t;
  if (k >= n) return;
  int* H = smem_long + t;
  int* E = smem_long + (long long)qmax * T + t;
  uint8_t* qc = reinterpret_cast<uint8_t*>(smem_long + 2ll * qmax * T) + t;
  const int rid = read_id[k];
  const int m = read_len[rid];
  const uint8_t* row = reads + (long long)rid * stride;
  for (int i = 0; i < m; ++i) qc[(long long)i * T] = tab[row[i]];
  const int wl = wlen[k];
  const bool is_rc = rc[k] != 0;
  const uint8_t* wrow = win + k * win_stride;
  auto ref = [&](int j) {
    return is_rc ? comp5(tab[wrow[wl - 1 - j]]) : (int)tab[wrow[j]];
  };
  auto query = [&](int i) { return (int)qc[(long long)i * T]; };
  int sc = 0, rb = 0, re = 0, qb = 0, qe = 0, clen = kFiltered;
  int* out = cigar_buf + k * ops_cap;
  if (m > 0) {
    const Ends fwd = forward_ends(query, m, ref, wl, p, H, E, T);
    sc = fwd.score;
    re = fwd.ref_end;
    qe = fwd.read_end;
    int re2 = 0, rd2 = 0;
    if (re >= 0) {
      const int qe0 = qe, re0 = re;
      const Ends rev = forward_ends(
          [&](int i) { return query(qe0 - i); }, qe + 1,
          [&](int j) { return ref(re0 - j); }, re + 1, p, H, E, T);
      if (rev.ref_end >= 0) {
        re2 = rev.ref_end;
        rd2 = rev.read_end;
      }
    }
    rb = re - re2;
    qb = qe - rd2;
    if (!(score_filter && sc < score_filter)) {
      const int read_sub = qe - qb + 1;
      const int ref_sub = re - rb + 1;
      int band = ref_sub - read_sub;
      if (band < 0) band = -band;
      band += 1;
      const int rb_c = rb < 0 ? 0 : rb;
      const int ref_n = re - rb_c + 1 > 0 ? re - rb_c + 1 : 0;
      const int hcap = band_ints(w_cap);
      int* band_rows = band_slab + k * 3ll * hcap;
      const int qb0 = qb;
      clen = banded_cigar(
          [&](int i) { return query(qb0 + i); }, read_sub,
          [&](int j) { return ref(rb_c + j); }, ref_n, sc, p, band,
          band_rows, band_rows + hcap, band_rows + 2 * hcap,
          dir_slab + k * (long long)qmax * (2ll * w_cap + 1), w_cap, out,
          ops_cap, max_ops);
      if (clen == kAborted) {
        sc = 0;  // ssw.c:941-944
      } else if (clen >= 0 && !is_rc) {
        for (int a = 0, b2 = clen - 1; a < b2; ++a, --b2) {
          const int tmp = out[a];
          out[a] = out[b2];
          out[b2] = tmp;
        }
      }
    }
  }
  if (is_rc) {
    const int rb2 = wl - (re + 1), re_2 = wl - (rb + 1);
    const int qb2 = m - (qe + 1), qe2 = m - (qb + 1);
    rb = rb2;
    re = re_2;
    qb = qb2;
    qe = qe2;
  }
  score[k] = sc;
  ref_begin[k] = rb + ref_start[k];
  ref_end[k] = re + ref_start[k];
  query_begin[k] = qb;
  query_end[k] = qe;
  cigar_len[k] = clen;
}

// --- sam_diff: one lane an alignment, its rows staged -------------------

// A text row written up to its cap; n counts on past it (the length the
// row needs).  Its first s_cap bytes go to the warp's shared buffer s
// (stored to the row p at the end), the rest straight to p.
struct Text {
  uint8_t* s;
  int s_cap;
  uint8_t* p;
  int cap;
  int n;
  __device__ void put(int c) {
    if (n < cap) {
      if (n < s_cap)
        s[n] = (uint8_t)c;
      else
        p[n] = (uint8_t)c;
    }
    ++n;
  }
  __device__ void num(long long v) {
    char d[20];
    int nd = 0;
    for (; v > 0xFFFFFFFFll; v /= 10) d[nd++] = (char)('0' + v % 10);
    unsigned u = static_cast<unsigned>(v);   // 32-bit division by 10
    do {
      d[nd++] = (char)('0' + u % 10u);
      u /= 10u;
    } while (u > 0);
    while (nd > 0) put(d[--nd]);
  }
};

// The walk's MD components merged as they come (SAM.h:192-217): numbers
// summed while they follow each other, `^` appending the next component
// as it is, a letter after a deletion preceded by "0".
struct Md {
  Text t;
  bool in_run, amb, consume, del_top;
  long long total;
  int top_mode;
  long long top_val;
  __device__ void flush() {
    if (in_run) {
      t.num(total);
      amb = false;
      in_run = false;
    }
  }
  __device__ void add(long long v) {
    if (!in_run) {
      in_run = true;
      total = 0;
    }
    total += v;
  }
  __device__ void number(long long v) {
    if (consume) {
      t.num(v);
      consume = false;
      amb = true;
      return;
    }
    add(v);
  }
  __device__ void letter(int c) {
    if (consume) {
      t.put(c);
      consume = false;
      amb = true;
      return;
    }
    if (c == '^') {
      flush();
      t.put('^');
      consume = true;
    } else if (c >= '0' && c <= '9') {
      add(c - '0');
    } else {
      flush();
      if (amb) {
        t.put('0');
        amb = false;
      }
      t.put(c);
    }
  }
  // a deletion's `^` component; its bases follow as one component,
  // appended as they are after the `^`.  After a consumed `^` (a `^` in
  // the reference) they are a component of the top level: a number if
  // they are digits, a `^` if they are one `^`, else letters.
  __device__ void del_begin() {
    if (consume) {
      t.put('^');
      consume = false;
      amb = true;
      del_top = true;
      top_mode = 0;
      top_val = 0;
    } else {
      flush();
      t.put('^');
      del_top = false;
    }
  }
  __device__ void letters() {
    flush();
    if (amb) {
      t.put('0');
      amb = false;
    }
  }
  // top_mode: 0 nothing yet, 1 digits, 2 letters, 3 a `^` so far
  __device__ void del_char(int c) {
    if (!del_top) {
      t.put(c);
      return;
    }
    const bool digit = c >= '0' && c <= '9';
    if (top_mode == 0) {
      if (digit) {
        top_mode = 1;
        top_val = c - '0';
      } else if (c == '^') {
        top_mode = 3;
      } else {
        top_mode = 2;
        letters();
        t.put(c);
      }
    } else if (top_mode == 1) {
      if (digit) top_val = top_val * 10 + (c - '0');
    } else if (top_mode == 3) {
      top_mode = 2;
      letters();
      t.put('^');
      t.put(c);
    } else {
      t.put(c);
    }
  }
  __device__ void del_end() {
    if (!del_top) {
      amb = true;
    } else if (top_mode == 1) {
      add(top_val);
    } else if (top_mode == 3) {
      flush();
      t.put('^');
      consume = true;
    }
  }
};

// Copies `need` bytes of a row to this lane's shared buffer: 16 B loads,
// four in flight at a time, when the row is on a 16 B boundary and the
// rows' pitch a multiple of 16 (the last word then stays inside the row),
// else 4 B loads or bytes, eight in flight.
__device__ __forceinline__ void stage_row(uint8_t* dst, const uint8_t* src,
                                          int need, long long pitch) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src) |
                       static_cast<uintptr_t>(pitch);
  if ((at & 15u) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const int words = (need + 15) >> 4;
    for (int v = 0; v < words; v += 4) {
      uint4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v + u < words) x[u] = __ldg(s4 + v + u);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v + u < words) d4[v + u] = x[u];
    }
  } else if ((at & 3u) == 0) {
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(dst);
    for (int v = 0; v < (need + 3) >> 2; ++v) d1[v] = __ldg(s1 + v);
  } else {
    for (int i = 0; i < need; i += 8) {
      uint8_t x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i + u < need) x[u] = __ldg(src + i + u);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i + u < need) dst[i + u] = x[u];
    }
  }
}

// One warp a block, 32 alignments, one lane an alignment k.  Dynamic
// shared memory: the two quality tables (2 x 100 doubles), the
// complement table (256 B), the warp's text lengths (2 x 32 ints), the
// lanes' queued MD calls (32 x kDiffEvents words), then a slot a lane:
// its read's first s_read bytes, its quality's, its window's first s_win
// bytes, its CIGAR and MD buffers (s_cig, s_md bytes).  Every size a
// multiple of 16.  Each lane stages its rows with 16 B loads, then the
// warp's lanes walk their cigars in lockstep (lanes that drift apart
// serialize); bytes past the staged parts are read from device memory.
// The warp stores the 32 texts as 16 B words, a row after another.
__global__ void __launch_bounds__(32) sam_diff_kernel(
    const uint8_t* __restrict__ reads, const uint8_t* __restrict__ qual,
    const int* __restrict__ read_len, const int* __restrict__ qual_len,
    long long stride, const uint8_t* __restrict__ comp,
    const int* __restrict__ read_id, const uint8_t* __restrict__ rc,
    const int* __restrict__ query_begin, const int* __restrict__ query_end,
    const int* __restrict__ cigar_buf, long long cigar_stride,
    const int* __restrict__ cigar_len, const uint8_t* __restrict__ dwin,
    long long dwin_stride, const int* __restrict__ dlen,
    const double* __restrict__ match_tbl,
    const double* __restrict__ mismatch_tbl, long long n, uint8_t* cig_txt,
    int cig_cap, int* cig_n, uint8_t* md_txt, int md_cap, int* md_n,
    int* nm_out, double* lp_out, int* ref_need, int s_read, int s_win,
    int s_cig, int s_md) {
  extern __shared__ __align__(16) uint8_t smem[];
  double* match_s = reinterpret_cast<double*>(smem);
  double* mism_s = match_s + 100;
  uint8_t* comp_s = reinterpret_cast<uint8_t*>(mism_s + 100);
  int* lens = reinterpret_cast<int*>(comp_s + 256);   // [2][32]
  uint32_t* events = reinterpret_cast<uint32_t*>(lens + 64);  // [32][E]
  uint8_t* slots = reinterpret_cast<uint8_t*>(events + 32 * kDiffEvents);
  const int lane = threadIdx.x;
  const unsigned full = 0xFFFFFFFFu;
  for (int i = lane; i < 100; i += 32) {
    match_s[i] = match_tbl[i];
    mism_s[i] = mismatch_tbl[i];
  }
  for (int i = lane; i < 256; i += 32) comp_s[i] = comp[i];
  const int per_slot = 2 * s_read + s_win + s_cig + s_md;
  uint8_t* read_s = slots + lane * per_slot;
  uint8_t* qual_s = read_s + s_read;
  uint8_t* win_s = qual_s + s_read;
  uint8_t* cig_s = win_s + s_win;
  uint8_t* md_s = cig_s + s_cig;
  uint4* z = reinterpret_cast<uint4*>(cig_s);   // cig_s, md_s adjacent
  for (int v = 0; v < (s_cig + s_md) >> 4; ++v)
    z[v] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  const long long k0 = (long long)blockIdx.x * 32;
  const long long k = k0 + lane;
  const int clen = k < n ? cigar_len[k] : kFiltered - 1;
  // this lane's walk (a cigar: [] for the abort and the filter)
  const bool walks = clen >= kFiltered;
  int m = 0, lq = 0, dl = 0, n_runs = clen > 0 ? clen : 0;
  bool is_rc = false;
  const uint8_t* rrow = reads;
  const uint8_t* qrow = qual;
  const uint8_t* wrow = dwin;
  const int* runs = cigar_buf;
  if (walks) {
    const int rid = read_id[k];
    m = read_len[rid];
    lq = qual_len[rid];
    is_rc = rc[k] != 0;
    rrow = reads + (long long)rid * stride;
    qrow = qual + (long long)rid * stride;
    wrow = dwin + k * dwin_stride;
    dl = dlen[k];
    runs = cigar_buf + k * cigar_stride;
    stage_row(read_s, rrow, min(m, s_read), stride);
    stage_row(qual_s, qrow, min(lq, s_read), stride);
    stage_row(win_s, wrow, min(dl, s_win), dwin_stride);
  }
  auto ref_at = [&](int pos) -> int {
    if (pos >= dl) return 0;
    return pos < s_win ? win_s[pos] : wrow[pos];
  };
  Text cig{cig_s, s_cig, cig_txt + (walks ? k : 0) * cig_cap, cig_cap, 0};
  Md md{{md_s, s_md, md_txt + (walks ? k : 0) * md_cap, md_cap, 0}, false,
        false, false, false, 0, 0, 0};
  int nm = 0, ref_pos = 0, q_pos = 0;
  double lp = 0.0;
  if (walks) {
    const int qb = query_begin[k];
    if (qb > 0) q_pos += qb;
  }
  // The walk in three warp-uniform loops: the bases, a step a lane each
  // round (a run's start, one base of an M or a D run), which add the
  // float64 chain in the walk's order and queue the MD state machine's
  // calls as events at the mismatches and the deletions; the events,
  // replayed in order by the state machine whenever a lane's queue may
  // fill and at the end; the CIGAR text, a run each round.
  uint32_t* ev = events + lane * kDiffEvents;
  int n_ev = 0;
  auto replay = [&]() {
    const int rounds = __reduce_max_sync(full, n_ev);
    for (int e = 0; e < rounds; ++e) {
      if (e >= n_ev) continue;
      const uint32_t x = ev[e];
      const int v = (int)(x & 0x1FFFFFFFu);
      switch (x >> 29) {
        case kEvNumber: md.number(v); break;
        case kEvLetter: md.letter(v); break;
        case kEvDelBegin: md.del_begin(); break;
        case kEvDelChar: md.del_char(v); break;
        default: md.del_end(); break;
      }
    }
    n_ev = 0;
  };
  auto push = [&](int type, int v) {
    ev[n_ev++] = ((uint32_t)type << 29) | (uint32_t)v;
  };
  int r = 0, b = -1, len = 0, op = 0, n_match = 0;
  bool done = !walks;
  while (__any_sync(full, !done)) {
    if (__any_sync(full, n_ev > kDiffEvents - 2)) replay();  // 2 a step
    if (done) continue;
    if (b < 0) {                    // a run's start, or the end
      if (r == n_runs) {
        done = true;
        continue;
      }
      len = runs[r] >> 4;
      op = runs[r] & 15;
      if (op == 1) {
        nm += len;
        q_pos += len;
        ++r;
        continue;
      }
      n_match = 0;
      if (op != 0) push(kEvDelBegin, 0);
      b = 0;
      if (len == 0) {
        if (op != 0) push(kEvDelEnd, 0);
        ++r;
        b = -1;
      }
      continue;
    }
    if (op == 0) {                  // a base of an M run
      const int rb = ref_at(ref_pos);
      int qy = 0;
      if (q_pos < m) {
        const int ri = is_rc ? m - 1 - q_pos : q_pos;
        qy = ri < s_read ? read_s[ri] : rrow[ri];
        if (is_rc) qy = comp_s[qy];
      }
      int qv = 1;
      if (q_pos < lq) {
        const int qi = is_rc ? lq - 1 - q_pos : q_pos;
        qv = (qi < s_read ? qual_s[qi] : qrow[qi]) - 33;
        qv = qv < 0 ? 0 : (qv > 99 ? 99 : qv);
      }
      if (rb == qy) {
        ++n_match;
        lp = __dadd_rn(lp, match_s[qv]);
      } else {
        ++nm;
        if (n_match) push(kEvNumber, n_match);
        push(kEvLetter, rb);
        lp = __dadd_rn(lp, mism_s[qv]);
        n_match = 0;
      }
      ++ref_pos;
      ++q_pos;
      if (++b == len) {
        if (n_match) push(kEvNumber, n_match);
        ++r;
        b = -1;
      }
    } else {                        // a base of a D run
      push(kEvDelChar, ref_at(ref_pos));
      ++nm;
      ++ref_pos;
      if (++b == len) {
        push(kEvDelEnd, 0);
        ++r;
        b = -1;
      }
    }
  }
  replay();
  // the CIGAR text: the soft clips and a run each round
  const int n_cig = walks ? n_runs : 0;
  const int cig_rounds = __reduce_max_sync(full, n_cig);
  if (walks) {
    md.flush();
    const int qb = query_begin[k];
    if (qb > 0) {
      cig.num(qb);
      cig.put('S');
    }
  }
  for (int x = 0; x < cig_rounds; ++x) {
    if (x >= n_cig) continue;
    const int run = runs[x];
    cig.num(run >> 4);
    cig.put("MID"[(run & 15) < 3 ? (run & 15) : 2]);
  }
  if (walks) {
    const int end_clip = m - query_end[k] - 1;
    if (end_clip > 0) {
      cig.num(end_clip);
      cig.put('S');
    }
  }
  const int cn = cig.n, mn = md.t.n;
  if (k < n) {
    cig_n[k] = cn;
    md_n[k] = mn;
    nm_out[k] = nm;
    lp_out[k] = lp;
    ref_need[k] = ref_pos;
  }
  // the texts' staged parts, as 16 B words where the rows' pitch allows
  lens[lane] = min(cn, min(cig_cap, s_cig));
  lens[32 + lane] = min(mn, min(md_cap, s_md));
  __syncwarp();
  const int n_here = n - k0 < 32 ? (int)(n - k0) : 32;
  for (int t = 0; t < 2; ++t) {
    const int cap = t ? md_cap : cig_cap;
    const int s_cap = t ? s_md : s_cig;
    uint8_t* txt = t ? md_txt : cig_txt;
    const uint8_t* base = slots + 2 * s_read + s_win + (t ? s_cig : 0);
    if (((reinterpret_cast<uintptr_t>(txt) | static_cast<uintptr_t>(cap)) &
         15u) == 0) {
      const int per = s_cap >> 4;                 // words a slot
      for (int i = lane; i < n_here * per; i += 32) {
        const int a = i / per, v = i % per;
        if (v < (lens[t * 32 + a] + 15) >> 4)
          reinterpret_cast<uint4*>(txt + (k0 + a) * cap)[v] =
              reinterpret_cast<const uint4*>(base + a * per_slot)[v];
      }
    } else {
      for (int i = lane; i < n_here * s_cap; i += 32) {
        const int a = i / s_cap, v = i % s_cap;
        if (v < lens[t * 32 + a])
          txt[(k0 + a) * cap + v] = base[a * per_slot + v];
      }
    }
  }
}

bool launch_ok(int threads, long long blocks) {
  return threads >= 1 && threads <= 1024 && blocks >= 1 &&
         blocks <= INT_MAX;
}

int round16(long long v) { return (int)((v + 15) & ~15ll); }

template <int R, bool kByte>
cudaError_t launch_pass(int log_g, dim3 grid, int threads, int smem,
                        cudaStream_t st, const uint8_t* reads,
                        const int* read_len, long long stride,
                        const uint8_t* tab, const uint8_t* win,
                        const int* wlen, long long win_stride,
                        const int* read_id, const uint8_t* rc,
                        const int* ref_start, long long n, Sw sw,
                        int* const* outs, int* cigar_len, int col_stride) {
  auto kernel = sam_pass_kernel<R, kByte>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, st>>>(
      reads, read_len, stride, tab, win, wlen, win_stride, read_id, rc,
      ref_start, n, sw, outs[0], outs[1], outs[2], outs[3], outs[4],
      cigar_len, log_g, col_stride);
  return cudaGetLastError();
}

template <int LB, bool kSlab>
cudaError_t launch_band_as(long long blocks, int smem, cudaStream_t st,
                           const void* reads, const void* read_len,
                           long long stride, const void* tab,
                           const void* win, const void* wlen,
                           long long win_stride, const void* read_id,
                           const void* rc, const void* ref_start,
                           long long n, Sw sw, int score_filter,
                           int max_ops, void* const* outs, void* cigar_buf,
                           void* cigar_len, int ops_cap, void* slab,
                           int w_cap, int skip_w, int qpitch, int rpitch,
                           int region, const long long* rows, int* main_buf,
                           int main_cap, int* stats) {
  auto kernel = sam_band_kernel<LB, kSlab>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, 32 * kBandWarps, smem, st>>>(
      static_cast<const uint8_t*>(reads), static_cast<const int*>(read_len),
      stride, static_cast<const uint8_t*>(tab),
      static_cast<const uint8_t*>(win), static_cast<const int*>(wlen),
      win_stride, static_cast<const int*>(read_id),
      static_cast<const uint8_t*>(rc), static_cast<const int*>(ref_start), n,
      sw, score_filter, max_ops, static_cast<int*>(outs[0]),
      static_cast<const int*>(outs[1]), static_cast<const int*>(outs[2]),
      static_cast<const int*>(outs[3]), static_cast<const int*>(outs[4]),
      static_cast<int*>(cigar_buf), static_cast<int*>(cigar_len), ops_cap,
      static_cast<uint8_t*>(slab), w_cap, skip_w, qpitch, rpitch, region,
      rows, main_buf, main_cap, stats);
  return cudaGetLastError();
}

// The band kernel over n alignments whose passes are in score / the ends
// (rows[t] the t-th, or all in order without rows): groups of 8 lanes
// with their regions in shared memory (the first launch: most bands are
// a few cells wide), or (slab) a warp an alignment with n regions in
// device memory (any band), skipping the attempts up to skip_w of the
// rows marked kRedo.
cudaError_t launch_band(const void* reads, const void* read_len,
                        long long stride, const void* tab, const void* win,
                        const void* wlen, long long win_stride,
                        long long width, const void* read_id,
                        const void* rc, const void* ref_start, long long n,
                        Sw sw, int score_filter, int max_ops,
                        void* const* outs, void* cigar_buf, void* cigar_len,
                        int ops_cap, void* slab, int w_cap, int skip_w,
                        const long long* rows, int* main_buf, int main_cap,
                        int* stats, cudaStream_t st) {
  const int lanes = slab ? 32 : 8;
  const int per_block = 32 * kBandWarps / lanes;
  const int qpitch = round16(stride);
  const int rpitch = round16(width);
  const int region = round16(12ll * band_ints(w_cap) +
                             stride * (2ll * w_cap + 1));
  const long long per_slot = qpitch + rpitch + (slab ? 0 : region);
  const long long smem = 256 + per_block * per_slot;
  const long long blocks = (n + per_block - 1) / per_block;
  if (!launch_ok(32 * kBandWarps, blocks) || smem > 232448)
    return cudaErrorInvalidValue;
#define KSLAM_BAND(L, S)                                                   \
  launch_band_as<L, S>(blocks, (int)smem, st, reads, read_len, stride,     \
                       tab, win, wlen, win_stride, read_id, rc, ref_start, \
                       n, sw, score_filter, max_ops, outs, cigar_buf,      \
                       cigar_len, ops_cap, slab, w_cap, skip_w, qpitch,    \
                       rpitch, region, rows, main_buf, main_cap, stats)
  const cudaError_t err = slab ? KSLAM_BAND(32, true) : KSLAM_BAND(8, false);
#undef KSLAM_BAND
  return err;
}

bool sam_params_ok(long long stride, long long width, int match, int go,
                   int ge, int w_cap, int ops_cap) {
  return stride >= 1 && stride <= 1024 && width <= 1024 &&
         match * stride <= 2047 && go >= ge && w_cap >= 1 && ops_cap >= 1;
}

}  // namespace

// One launch of sam_cigar over n alignments: the passes (groups of
// `group` lanes, `rows` query rows a lane, `threads` a block,
// `col_stride` score words an alignment, `smem` bytes of dynamic shared
// memory a block), then the band kernel (groups of 8 lanes, the band
// regions in shared memory: half-widths up to w_cap).  cigar_buf: n *
// ops_cap ints.  The runs of a band wider than w_cap, or longer than
// ops_cap, are left to kslam_sam_band (cigar_len REDO, REDO_OPS).
extern "C" int kslam_sam_cigar(
    const void* reads, const void* read_len, long long stride,
    const void* tab, const void* win, const void* wlen, long long win_stride,
    long long width, const void* read_id, const void* rc,
    const void* ref_start, long long n, int match, int mismatch,
    int gap_open, int gap_extend, int score_filter, int max_ops,
    void* score, void* ref_begin, void* ref_end, void* query_begin,
    void* query_end, void* cigar_buf, void* cigar_len, int ops_cap,
    int w_cap, int group, int rows, int col_stride, int threads, int smem,
    int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  int log_g = 0;
  while ((1 << log_g) < group) ++log_g;
  const int per_block = threads / (group > 0 ? group : 1);
  const long long blocks = per_block > 0 ? (n + per_block - 1) / per_block
                                         : 0;
  const long long smem_min =
      round16((long long)per_block * (col_stride + 2) * 4 + 256);
  if ((1 << log_g) != group || group > 32 || group * rows < stride ||
      group * rows > 1024 || col_stride < width || threads % 32 != 0 ||
      threads > kGroupThreads || threads < group ||
      !launch_ok(threads, blocks) || smem < smem_min ||
      !sam_params_ok(stride, width, match, gap_open, gap_extend, w_cap,
                     ops_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool byte = match >= -128 && match <= 127 && -mismatch >= -128 &&
                    -mismatch <= 127;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* outs[5] = {static_cast<int*>(score), static_cast<int*>(ref_begin),
                  static_cast<int*>(ref_end), static_cast<int*>(query_begin),
                  static_cast<int*>(query_end)};
  const Sw sw{match, mismatch, gap_open, gap_extend};
  cudaError_t err = cudaErrorInvalidValue;
#define KSLAM_ARGS                                                         \
  log_g, dim3((unsigned)blocks), threads, smem, st,                        \
      static_cast<const uint8_t*>(reads), static_cast<const int*>(read_len), \
      stride, static_cast<const uint8_t*>(tab),                            \
      static_cast<const uint8_t*>(win), static_cast<const int*>(wlen),     \
      win_stride, static_cast<const int*>(read_id),                        \
      static_cast<const uint8_t*>(rc), static_cast<const int*>(ref_start), \
      n, sw, outs, static_cast<int*>(cigar_len), col_stride
#define KSLAM_ROWS(RR)                                                     \
  case RR:                                                                 \
    err = byte ? launch_pass<RR, true>(KSLAM_ARGS)                         \
               : launch_pass<RR, false>(KSLAM_ARGS);                       \
    break;
  switch (rows) {
    KSLAM_ROWS(4)
    KSLAM_ROWS(8)
    KSLAM_ROWS(12)
    KSLAM_ROWS(16)
    KSLAM_ROWS(20)
    KSLAM_ROWS(24)
    KSLAM_ROWS(32)
    default:
      break;
  }
#undef KSLAM_ROWS
#undef KSLAM_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  void* const band_outs[5] = {score, ref_begin, ref_end, query_begin,
                              query_end};
  return static_cast<int>(launch_band(
      reads, read_len, stride, tab, win, wlen, win_stride, width, read_id,
      rc, ref_start, n, sw, score_filter, max_ops, band_outs, cigar_buf,
      cigar_len, ops_cap, nullptr, w_cap, 0, nullptr, nullptr, 1, nullptr,
      st));
}

// The band kernel alone over the n alignments rows[0..n) whose passes
// are already in score and the ends (kslam_sam_cigar's REDO and REDO_OPS
// rows, with their cigar_len), in the full columns: a warp an alignment,
// the t-th's band region in `slab` (n regions of round16(12
// band_ints(w_cap) + stride (2 w_cap + 1)) bytes), its runs in cigar_buf
// row t (ops_cap ints, zero past them) and, when they fit, in main_buf
// row rows[t] (main_cap ints), half-widths up to w_cap; a REDO row starts
// past the first launch's skip_w.  stats (two ints, zeroed): the rows
// still flagged, the most runs of a row.
extern "C" int kslam_sam_band(
    const void* reads, const void* read_len, long long stride,
    const void* tab, const void* win, const void* wlen, long long win_stride,
    long long width, const void* read_id, const void* rc,
    const void* ref_start, long long n, int match, int mismatch,
    int gap_open, int gap_extend, int score_filter, int max_ops,
    void* score, void* ref_begin, void* ref_end, void* query_begin,
    void* query_end, void* cigar_buf, void* cigar_len, int ops_cap,
    void* slab, int w_cap, int skip_w, const void* rows, void* main_buf,
    int main_cap, void* stats, int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  if (slab == nullptr || rows == nullptr || cigar_buf == nullptr ||
      main_buf == nullptr || stats == nullptr || main_cap < 1 ||
      !sam_params_ok(stride, width, match, gap_open, gap_extend, w_cap,
                     ops_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  void* const outs[5] = {score, ref_begin, ref_end, query_begin, query_end};
  return static_cast<int>(launch_band(
      reads, read_len, stride, tab, win, wlen, win_stride, width, read_id,
      rc, ref_start, n, Sw{match, mismatch, gap_open, gap_extend},
      score_filter, max_ops, outs, cigar_buf, cigar_len, ops_cap, slab,
      w_cap, skip_w, static_cast<const long long*>(rows),
      static_cast<int*>(main_buf), main_cap, static_cast<int*>(stats),
      static_cast<cudaStream_t>(stream)));
}

// One launch of sam_cigar_long over n alignments (one thread each,
// `threads` a block).  dir_slab: n * qmax * (2 w_cap + 1) bytes;
// band_slab: n * 3 * band_ints(w_cap) ints; cigar_buf: n * ops_cap ints.
extern "C" int kslam_sam_cigar_long(
    const void* reads, const void* read_len, long long stride,
    const void* tab, const void* win, const void* wlen, long long win_stride,
    const void* read_id, const void* rc, const void* ref_start, long long n,
    int match, int mismatch, int gap_open, int gap_extend, int score_filter,
    int max_ops, void* score, void* ref_begin, void* ref_end,
    void* query_begin, void* query_end, void* cigar_buf, void* cigar_len,
    int ops_cap, void* dir_slab, void* band_slab, int w_cap, int qmax,
    int threads, int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  const long long blocks = (n + threads - 1) / threads;
  if (!launch_ok(threads, blocks) || qmax < 0 || w_cap < 1 || ops_cap < 1 ||
      stride < qmax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)threads * qmax * 9;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sam_cigar_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sam_cigar_long_kernel<<<(unsigned)blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads), static_cast<const int*>(read_len),
      stride, static_cast<const uint8_t*>(tab),
      static_cast<const uint8_t*>(win), static_cast<const int*>(wlen),
      win_stride, static_cast<const int*>(read_id),
      static_cast<const uint8_t*>(rc), static_cast<const int*>(ref_start), n,
      Sw{match, mismatch, gap_open, gap_extend}, score_filter, max_ops,
      static_cast<int*>(score), static_cast<int*>(ref_begin),
      static_cast<int*>(ref_end), static_cast<int*>(query_begin),
      static_cast<int*>(query_end), static_cast<int*>(cigar_buf),
      static_cast<int*>(cigar_len), ops_cap,
      static_cast<uint8_t*>(dir_slab), static_cast<int*>(band_slab), w_cap,
      qmax);
  return static_cast<int>(cudaGetLastError());
}

// One launch of sam_diff over n alignments, a lane each, a warp a block:
// text rows of cig_cap and md_cap bytes; the lengths written are the
// lengths the rows need.
extern "C" int kslam_sam_diff(
    const void* reads, const void* qual, const void* read_len,
    const void* qual_len, long long stride, const void* comp,
    const void* read_id, const void* rc, const void* query_begin,
    const void* query_end, const void* cigar_buf, long long cigar_stride,
    const void* cigar_len, const void* dwin, long long dwin_stride,
    const void* dlen, const void* match_tbl, const void* mismatch_tbl,
    long long n, void* cig_txt, int cig_cap, void* cig_n, void* md_txt,
    int md_cap, void* md_n, void* nm, void* lp, void* ref_need, int device,
    void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  const long long blocks = (n + 31) / 32;
  if (!launch_ok(32, blocks) || cig_cap < 1 || md_cap < 1 || stride < 0 ||
      dwin_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // staged prefixes: up to 1 KB of each row, 256 B of each text
  const int s_read = round16(stride < 1024 ? stride : 1024);
  const int s_win = round16(dwin_stride < 1024 ? dwin_stride : 1024);
  const int s_cig = round16(cig_cap < 256 ? cig_cap : 256);
  const int s_md = round16(md_cap < 256 ? md_cap : 256);
  const int smem = 2 * 100 * 8 + 256 + 2 * 32 * 4 + 32 * kDiffEvents * 4 +
                   32 * (2 * s_read + s_win + s_cig + s_md);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sam_diff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sam_diff_kernel<<<(unsigned)blocks, 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads), static_cast<const uint8_t*>(qual),
      static_cast<const int*>(read_len), static_cast<const int*>(qual_len),
      stride, static_cast<const uint8_t*>(comp),
      static_cast<const int*>(read_id), static_cast<const uint8_t*>(rc),
      static_cast<const int*>(query_begin),
      static_cast<const int*>(query_end), static_cast<const int*>(cigar_buf),
      cigar_stride, static_cast<const int*>(cigar_len),
      static_cast<const uint8_t*>(dwin), dwin_stride,
      static_cast<const int*>(dlen), static_cast<const double*>(match_tbl),
      static_cast<const double*>(mismatch_tbl), n,
      static_cast<uint8_t*>(cig_txt), cig_cap, static_cast<int*>(cig_n),
      static_cast<uint8_t*>(md_txt), md_cap, static_cast<int*>(md_n),
      static_cast<int*>(nm), static_cast<double*>(lp),
      static_cast<int*>(ref_need), s_read, s_win, s_cig, s_md);
  return static_cast<int>(cudaGetLastError());
}
