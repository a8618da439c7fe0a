// The SAM path's two kernels: sam_cigar (the cigar of each SAM alignment,
// as the native host call kslam_ssw_cigar_batch in csrc/ssw_batch.cc
// computes it for one overlap) and sam_diff (io/sam.py's
// get_cigar_and_md: the CIGAR and MD texts, NM and the log10
// probability).  Glue, checks and plain versions: ops/sam_cuda.py.
//
// They replace host work, not a Pallas kernel: ssw_batch.cc:229-345
// (OpenMP) and the per-base Python loop of io/sam.py:40-121.
//
// What bounds them on the H100.  sam_cigar is integer work: the forward
// pass and the reverse pass over the reversed prefixes are ~2 x 150 x 150
// cells an alignment; the banded DP is a few cells a row, the traceback a
// few hundred steps.  The first design is one thread an alignment, the
// native code's own loops in the same order: its H and E columns live in
// shared memory, interleaved by thread (row i of thread t at i * T + t,
// so a warp's accesses fall in distinct banks), with the query's SW codes
// beside them; its band rows and direction bytes live in device scratch,
// one slab an alignment.  A direction cell packs the native's three
// direction bytes into one (bit 0: E's 3 over 2, bit 1: F's 5 over 4,
// bits 2-4: H's 1..5; 0: never written), read back at the native's flat
// index so that a traceback leaving its band row reads what the native
// reads.  A band wider than the slab, or a cigar longer than its row,
// writes REDO and the wrapper relaunches that alignment with a slab for
// any band.  sam_diff reads a read, its quality and a reference window
// and writes two short texts: bytes, one thread an alignment.
//
// Exactness: every comparison, tie and quirk of ssw_batch.cc is kept as
// written (the band arrays' edge and row-0 zeroing, E read in place, the
// last non-empty row's length carried into the copy, the merged leading
// M, the run-count abort); the float64 probability is summed with
// __dadd_rn, in the walk's order, from the walk's own tables.

#include <climits>
#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kAborted = -1;
constexpr int kFiltered = -2;
constexpr int kRedo = -3;
constexpr long long kWidthLimit = 1ll << 31;  // ssw.c:631-642

struct Sw {
  int match, mismatch, go, ge;
};

__device__ __forceinline__ int sub_score(int q, int r, const Sw& p) {
  return (q == 4 || r == 4) ? 0 : (q == r ? p.match : -p.mismatch);
}

__device__ __forceinline__ int comp5(int c) { return c < 4 ? c ^ 2 : c; }

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
  const int kNeg = INT_MIN / 4;
  int best = 0, best_col = -1, best_row = 0;
  for (int j = 0; j < n; ++j) {
    const int rj = r(j);
    int diag = 0, f = kNeg, colmax = 0, colrow = 0;
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

// banded_cigar (ssw_batch.cc:104-200).  rd(i): read codes of the
// [begin..end] sub-sequence, rf(j): ref codes.  hb/eb/hc: this
// alignment's band rows (>= max(2 w_cap + 5, 8) ints each); dir: its slab
// (>= read_len * (2 w_cap + 1) bytes).  Writes runs in traceback order to
// out (ops_cap of them at most) and returns their count, kAborted, or
// kRedo when the band outgrows w_cap or the runs outgrow ops_cap.
template <class RD, class RF>
__device__ int banded_cigar(RD rd, int read_len, RF rf, int ref_len,
                            int score, const Sw& p, int band_width, int* hb,
                            int* eb, int* hc, uint8_t* dir, int w_cap,
                            int* out, int ops_cap, int max_ops) {
  int w;
  for (;;) {
    w = band_width;
    const long long width = 2ll * w + 3;
    const long long width_d = 2ll * w + 1;
    if (width_d * read_len * 3 >= kWidthLimit) return kAborted;
    if (w > w_cap) return kRedo;
    const int hsz = width + 2 > 8 ? (int)width + 2 : 8;
    for (int k = 0; k < hsz; ++k) hb[k] = eb[k] = hc[k] = 0;
    for (long long k = 0; k < read_len * width_d; ++k) dir[k] = 0;
    int max_score = 0;
    long long u = 0;
    for (int i = 0; i < read_len; ++i) {
      const int beg = i - w > 0 ? i - w : 0;
      const int end = i + w < ref_len - 1 ? i + w : ref_len - 1;
      const long long edge = end + 1 < width - 1 ? end + 1 : width - 1;
      int f = 0;
      hb[0] = eb[0] = hb[edge] = eb[edge] = hc[0] = 0;
      uint8_t* dline = dir + (long long)i * width_d;
      const int x_i = i - w > 0 ? i - w : 0;
      const int x_im1 = i - 1 - w > 0 ? i - 1 - w : 0;
      const int rdi = rd(i);
      for (int j = beg; j <= end; ++j) {
        u = j - x_i + 1;
        const long long e_idx = j - x_im1 + 1;
        const long long b = j - 1 - x_i + 1;
        const long long d = j - 1 - x_im1 + 1;
        int t1 = i == 0 ? -p.go : hb[e_idx] - p.go;
        int t2 = i == 0 ? -p.ge : eb[e_idx] - p.ge;
        const int e_new = t1 > t2 ? t1 : t2;
        const int d0 = t1 > t2 ? 3 : 2;
        t1 = hc[b] - p.go;
        t2 = f - p.ge;
        f = t1 > t2 ? t1 : t2;
        const int d1 = t1 > t2 ? 5 : 4;
        const int e1 = e_new > 0 ? e_new : 0;
        const int f1 = f > 0 ? f : 0;
        t1 = e1 > f1 ? e1 : f1;
        t2 = hb[d] + sub_score(rdi, rf(j), p);
        eb[u] = e_new;
        const int h = t1 > t2 ? t1 : t2;
        hc[u] = h;
        if (h > max_score) max_score = h;
        const int d2 = t1 <= t2 ? 1 : (e1 > f1 ? d0 : d1);
        dline[j - x_i] = (uint8_t)((d0 == 3) | ((d1 == 5) << 1) | (d2 << 2));
      }
      for (long long k = 1; k <= u; ++k) hb[k] = hc[k];
    }
    if (max_score >= score) break;
    // a band over every cell repeats this DP at any width: the native
    // doubles on to its width check and aborts there
    if (w >= read_len - 1 && w >= ref_len - 1) return kAborted;
    band_width *= 2;
  }
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
    switch (decode_dir(dir[idx / 3], (int)(idx % 3))) {
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
  if (n_runs > ops_cap) return kRedo;
  return n_runs;
}

// One thread an alignment k < n.  Dynamic shared memory: H [qmax][T]
// ints, E [qmax][T] ints, the query's codes [qmax][T] bytes.
__global__ void sam_cigar_kernel(
    const uint8_t* __restrict__ reads, const int* __restrict__ read_len,
    long long stride, const uint8_t* __restrict__ tab,
    const uint8_t* __restrict__ win, const int* __restrict__ wlen,
    long long win_stride, const int* __restrict__ read_id,
    const uint8_t* __restrict__ rc, const int* __restrict__ ref_start,
    long long n, Sw p, int score_filter, int max_ops, int* score,
    int* ref_begin, int* ref_end, int* query_begin, int* query_end,
    int* cigar_buf, int* cigar_len, int ops_cap, uint8_t* dir_slab,
    int* band_slab, int w_cap, int qmax) {
  extern __shared__ int smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long k = (long long)blockIdx.x * T + t;
  if (k >= n) return;
  int* H = smem + t;
  int* E = smem + (long long)qmax * T + t;
  uint8_t* qc = reinterpret_cast<uint8_t*>(smem + 2ll * qmax * T) + t;
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
      const int hcap = 2 * w_cap + 5 > 8 ? 2 * w_cap + 5 : 8;
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
        // the runs came in traceback order: forward order for a forward
        // hit, and for rc the native's two reversals cancel
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

// A text row written up to its cap; n counts on past it (the length the
// row needs).
struct Text {
  uint8_t* p;
  int cap;
  int n;
  __device__ void put(int c) {
    if (n < cap) p[n] = (uint8_t)c;
    ++n;
  }
  __device__ void num(long long v) {
    char d[20];
    int nd = 0;
    do {
      d[nd++] = (char)('0' + v % 10);
      v /= 10;
    } while (v > 0);
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

__global__ void sam_diff_kernel(
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
    int* nm_out, double* lp_out, int* ref_need) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    Text cig{cig_txt + k * cig_cap, cig_cap, 0};
    Md md{{md_txt + k * md_cap, md_cap, 0}, false, false, false, false, 0,
          0, 0};
    int nm = 0;
    double lp = 0.0;
    long long ref_pos = 0;
    const int clen = cigar_len[k];
    if (clen >= kFiltered) {  // a cigar: [] for the abort and the filter
      const int rid = read_id[k];
      const int m = read_len[rid];
      const int lq = qual_len[rid];
      const bool is_rc = rc[k] != 0;
      const uint8_t* rrow = reads + (long long)rid * stride;
      const uint8_t* qrow = qual + (long long)rid * stride;
      const uint8_t* wrow = dwin + k * dwin_stride;
      const int dl = dlen[k];
      const int* runs = cigar_buf + k * cigar_stride;
      int q_pos = 0;
      const int qb = query_begin[k];
      if (qb > 0) {
        cig.num(qb);
        cig.put('S');
        q_pos += qb;
      }
      for (int r = 0; r < clen; ++r) {
        const int len = runs[r] >> 4;
        const int op = runs[r] & 15;
        cig.num(len);
        if (op == 0) {
          cig.put('M');
          long long n_match = 0;
          for (int b = 0; b < len; ++b) {
            const int rb = ref_pos < dl ? wrow[ref_pos] : 0;
            const int qy = q_pos < m
                               ? (is_rc ? comp[rrow[m - 1 - q_pos]]
                                        : rrow[q_pos])
                               : 0;
            int qv = 1;
            if (q_pos < lq) {
              qv = (is_rc ? qrow[lq - 1 - q_pos] : qrow[q_pos]) - 33;
              qv = qv < 0 ? 0 : (qv > 99 ? 99 : qv);
            }
            if (rb == qy) {
              ++n_match;
              lp = __dadd_rn(lp, match_tbl[qv]);
            } else {
              ++nm;
              if (n_match) md.number(n_match);
              md.letter(rb);
              lp = __dadd_rn(lp, mismatch_tbl[qv]);
              n_match = 0;
            }
            ++ref_pos;
            ++q_pos;
          }
          if (n_match) md.number(n_match);
        } else if (op == 1) {
          cig.put('I');
          nm += len;
          q_pos += len;
        } else {
          cig.put('D');
          md.del_begin();
          for (int b = 0; b < len; ++b) {
            md.del_char(ref_pos < dl ? wrow[ref_pos] : 0);
            ++nm;
            ++ref_pos;
          }
          md.del_end();
        }
      }
      const int end_clip = m - query_end[k] - 1;
      if (end_clip > 0) {
        cig.num(end_clip);
        cig.put('S');
      }
      md.flush();
    }
    cig_n[k] = cig.n;
    md_n[k] = md.t.n;
    nm_out[k] = nm;
    lp_out[k] = lp;
    ref_need[k] = (int)ref_pos;
  }
}

bool launch_ok(int threads, long long blocks) {
  return threads >= 1 && threads <= 1024 && blocks >= 1 &&
         blocks <= INT_MAX;
}

}  // namespace

// One launch of sam_cigar over n alignments (one thread each, `threads`
// a block).  dir_slab: n * qmax * (2 w_cap + 1) bytes; band_slab: n * 3 *
// max(2 w_cap + 5, 8) ints; cigar_buf: n * ops_cap ints.
extern "C" int kslam_sam_cigar(
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
        sam_cigar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sam_cigar_kernel<<<(unsigned)blocks, threads, smem,
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

// One launch of sam_diff over n alignments: text rows of cig_cap and
// md_cap bytes; the lengths written are the lengths the rows need.
extern "C" int kslam_sam_diff(
    const void* reads, const void* qual, const void* read_len,
    const void* qual_len, long long stride, const void* comp,
    const void* read_id, const void* rc, const void* query_begin,
    const void* query_end, const void* cigar_buf, long long cigar_stride,
    const void* cigar_len, const void* dwin, long long dwin_stride,
    const void* dlen, const void* match_tbl, const void* mismatch_tbl,
    long long n, void* cig_txt, int cig_cap, void* cig_n, void* md_txt,
    int md_cap, void* md_n, void* nm, void* lp, void* ref_need, int threads,
    int blocks, int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  if (!launch_ok(threads, blocks) || cig_cap < 1 || md_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  sam_diff_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<int*>(ref_need));
  return static_cast<int>(cudaGetLastError());
}
