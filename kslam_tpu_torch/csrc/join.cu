// The k-mer join's table lookups for Hopper: sector_join, bucket_join
// and window_join.  Each has two modes.  As a lookup it returns, for every
// query key, (lo int64, hi int64, uncovered int32) exactly as the plain
// versions in ops/join.py do.  With tier 2 (ops/match.join_bounds on the
// card) it also takes q_ok and returns only (lo, hi): every kept query
// its table leaves uncovered gets the exact insertion points of the
// sorted index keys, found in the same launch, as join_bounds' plain
// version (lookup, torch.nonzero, searchsorted_both, index_put) gives.
//
// What they compute.  The reference package's join is XLA ops, not a
// Pallas kernel: on the TPU XLA fuses each lookup into a few passes.
// * sector_join: the port's stand-in for kslam_tpu/ops/join.py:146-191
//   (lookup_bucket) and the join of every single-device path.  The same
//   CDF map reaches a row of the sector table (db/sector_table.py, int32
//   [2^bits, 8], one 32 B sector a row): w0 start, w1 t_base (u32),
//   w2..w5 four low-32 words, w6 the 12-bit t-deltas of slots 0 and 1,
//   w7 those of slots 2 and 3, the count (3 bits at 24) and the escape
//   bit (27).  A covered row's count is at most 4 and lo, hi come from
//   its slot words as below; an escaped row holds its run's length in
//   w2: lo = hi = start, uncovered = w2.
// * bucket_join: kslam_tpu/ops/join.py:146-191 (lookup_bucket).  A key's
//   word is mapped to a row of the bucket table (KmerIndex.bucket_table,
//   int32 [2^bits, 16]) by the CDF map t = word >> 32,
//   v = 2t - floor(t^2 / 2^32), row = min(v >> (32 - bits), 2^bits - 1).
//   The row holds c0 start, c1 count | ESCAPE (1 << 30), c2 t_base (u32),
//   c3..c6 eight 12-bit t-deltas (two per word, slot s at bit 12*(s%2) of
//   c[3 + s/2]), c7..c14 eight low-32 words.  Slot s < count holds the
//   word ((t_base + delta_s) mod 2^32) << 32 | low32_s; lt and eq count
//   the slot words below and equal to the query's word.
//   lo = start + (covered ? lt : 0), hi = lo + (covered ? eq : 0),
//   uncovered = covered ? 0 : count.
// * window_join: kslam_tpu/ops/join.py:244-288 (lookup_prefix_window).
//   p = the top prefix_bits of the word, start = pstart[p],
//   end = pstart[p + 1], pos0 = (start / w) * w; the reference counts
//   the index keys below and equal to the query over all 2w slots
//   [pos0, pos0 + 2w).  covered = end <= pos0 + 2w; lo = covered ?
//   pos0 + lt : start, hi = covered ? lo + eq : start, uncovered =
//   covered ? 0 : end - start.
// Keys are int64 with the top bit flipped (ops/kmers.py); every compare
// here is on the unsigned word, key ^ 2^63.
//
// The run is enough.  Both tables address a contiguous run of the
// sorted keys: a bucket row's [c0, c0 + count) (the CDF map is monotone
// in the word) and a prefix's [start, end).  Every key before the run
// is below the query and every key from the run's end on is above it,
// save one edge: the index is padded with int64-max sentinels (the
// all-ones word) after its M real keys, and the tables count real keys
// only (pstart[2^bits] = M; the last bucket ends at M), so for the
// all-ones query the sentinels after the run are equal, not above.  No
// canonical k-mer is all ones (it is the zero k-mer's reverse
// complement), but the lookups must still agree with the references:
// * window_join's slots [pos0, start) add start - pos0 to lt, and the
//   slots [end, pos0 + 2w) add nothing, so lo = start + #(run < q) and
//   hi = lo + #(run == q); for the all-ones query every slot is <= q, so
//   hi = pos0 + 2w (the slots inside the keys: min(pos0 + 2w, n_keys)).
// * tier 2: lo = the lower bound of q in the run, hi = its upper bound;
//   for the all-ones query every key is <= q, so hi = n_keys, as
//   torch.searchsorted(right=True) over the padded keys gives.
//
// What bounds them on the H100: bytes, and the latency of dependent
// random loads.  There is no arithmetic to speak of.
// * sector_join: one thread per query (grid-stride loop).  Per query its
//   8 B key, one 32 B row and the outputs: the row is two independent
//   16 B read-only loads (ld.global.nc.v4) of one sector, as the table
//   is 32 B aligned (the wrapper checks).  The bucket table's row took
//   two sectors for eight slots, of which ~1.5 were in use (1e8 keys
//   over 2^26 rows); four slots cover a row unless it holds five keys
//   or more, and those queries (a few %, PERF.md) go to tier 2 from the
//   same sector.  A table of 2^26 rows is 2 GiB, not 4, which halves the
//   TLB and DRAM-page reach the random rows cost.
// * bucket_join: one thread per query (grid-stride loop).  Per query
//   its 8 B key, one 64 B row (two 32 B sectors) and the outputs.  The
//   row is four independent 16 B read-only loads (ld.global.nc.v4), so
//   a thread has its whole row in flight at once; the table is 64 B
//   aligned (the wrapper checks), so a row is two sectors.  The CDF map
//   is one __umulhi.  The eight slot compares are unrolled in registers.
// * window_join: one thread per query (grid-stride loop), 32
//   registers, so 2048 queries are in flight per SM.  Three dependent
//   steps: the key (coalesced), pstart[p] and pstart[p + 1] (one sector,
//   usually), then the run's keys as independent 8 B loads.  A run holds
//   about 1.5 keys at 26 prefix bits over 1e8 keys; the two rows around
//   it are not read.  Giving a thread 2 or 4 queries, their loads issued
//   together, was measured no faster: two dependent random sectors a
//   query are the limit, not the loads in flight.
// * tier 2 (both): a binary search of the escaped run, whose bounds the
//   thread already holds (lower bound, then the upper bound from it);
//   q_ok is read only for uncovered queries.  No compaction, no
//   synchronisation: the launch writes lo and hi of every query.
// Random 64 B rows over a table of up to 4 GiB cost TLB and DRAM page
// misses that the bytes bound does not count.
//
// Limits (checked by the wrapper, ops/join_cuda.py): bits in 1..32 (the
// sector table 32 B aligned);
// prefix_bits in 1..31; w a power of two in 2..4096 (a covered run is at
// most 2w keys, scanned in full) with the keys' length a multiple of w
// and >= 2w; the table 64 B aligned.  A run is read only inside the
// keys [0, n_keys): a table that points past them (no valid input does)
// counts nothing there.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned long long kFlip = 0x8000000000000000ull;
constexpr unsigned long long kAllOnes = ~0ull;
constexpr int kEscape = 1 << 30;
constexpr int kSlots = 8;          // KmerIndex.BUCKET_SLOTS
constexpr int kDeltaBits = 12;     // KmerIndex.BUCKET_DELTA_BITS
constexpr int kSectorSlots = 4;    // sector_table.SLOTS
constexpr int kCountShift = 24;    // sector_table.COUNT_SHIFT
constexpr int kEscapeShift = 27;   // sector_table.ESCAPE_SHIFT
constexpr int kMaxThreads = 256;
constexpr int kMaxWindow = 4096;

__device__ __forceinline__ unsigned long long word_of(long long key) {
  return static_cast<unsigned long long>(key) ^ kFlip;
}

// The first position in [a, b) whose word is not below (kUpper: is
// above) `word`; b if none.
template <bool kUpper>
__device__ __forceinline__ long long search(const long long* keys,
                                            long long a, long long b,
                                            unsigned long long word) {
  while (a < b) {
    const long long mid = a + ((b - a) >> 1);
    const unsigned long long x = word_of(__ldg(keys + mid));
    if (kUpper ? x <= word : x < word)
      a = mid + 1;
    else
      b = mid;
  }
  return a;
}

// Tier 2: the exact (lo, hi) of `word` in the sorted keys, given the run
// [a, b) that holds every key equal to it (module comment).
__device__ __forceinline__ void exact_bounds(const long long* keys,
                                             long long n_keys, long long a,
                                             long long b,
                                             unsigned long long word,
                                             long long& lo, long long& hi) {
  b = min(b, n_keys);
  lo = search<false>(keys, a, b, word);
  hi = word == kAllOnes ? n_keys : search<true>(keys, lo, b, word);
}

// The slot word of a covered row: ((t_base + delta) << 32) | low.
__device__ __forceinline__ unsigned long long slot_word(unsigned int t_base,
                                                        int deltas, int s,
                                                        int low) {
  // deltas is int32: an arithmetic shift, then the mask
  const unsigned int delta = static_cast<unsigned int>(
      (deltas >> (kDeltaBits * (s % 2))) & ((1 << kDeltaBits) - 1));
  return (static_cast<unsigned long long>(t_base + delta) << 32) |
         static_cast<unsigned int>(low);
}

// The CDF map: v = 2t - floor(t^2 / 2^32) <= 2^32, 2^32 only at
// t = 2^32 - 1, which the clamp puts in the last row.
__device__ __forceinline__ unsigned long long row_of(unsigned long long word,
                                                     int bits) {
  const unsigned int t = static_cast<unsigned int>(word >> 32);
  const unsigned long long v = 2ull * t - __umulhi(t, t);
  return min(v >> (32 - bits), (1ull << bits) - 1);
}

template <bool kTier2>
__global__ void __launch_bounds__(kMaxThreads)
    sector_join_kernel(const long long* __restrict__ queries,
                       const int4* __restrict__ tbl, long long n, int bits,
                       const long long* __restrict__ keys, long long n_keys,
                       const unsigned char* __restrict__ q_ok,
                       long long* __restrict__ lo_out,
                       long long* __restrict__ hi_out,
                       int* __restrict__ unc_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long word = word_of(__ldg(queries + i));
    const int4* r = tbl + row_of(word, bits) * 2;
    // one sector: a = w0..w3, b = w4..w7
    const int4 a = __ldg(r), b = __ldg(r + 1);
    const bool escaped = (b.w >> kEscapeShift) & 1;
    const int cnt = (b.w >> kCountShift) & 7;
    const unsigned int t_base = static_cast<unsigned int>(a.y);
    const int lows[kSectorSlots] = {a.z, a.w, b.x, b.y};
    const int deltas[kSectorSlots / 2] = {b.z, b.w};
    int lt = 0, eq = 0;
#pragma unroll
    for (int s = 0; s < kSectorSlots; ++s) {
      const unsigned long long slot =
          slot_word(t_base, deltas[s / 2], s, lows[s]);
      const bool in_run = s < cnt;
      lt += in_run && slot < word;
      eq += in_run && slot == word;
    }
    long long lo = static_cast<long long>(a.x) + (escaped ? 0 : lt);
    long long hi = lo + (escaped ? 0 : eq);
    if (kTier2) {
      if (escaped && a.z > 0 && q_ok[i])
        exact_bounds(keys, n_keys, a.x, static_cast<long long>(a.x) + a.z,
                     word, lo, hi);
    } else {
      unc_out[i] = escaped ? a.z : 0;
    }
    lo_out[i] = lo;
    hi_out[i] = hi;
  }
}

template <bool kTier2>
__global__ void __launch_bounds__(kMaxThreads)
    bucket_join_kernel(const long long* __restrict__ queries,
                       const int4* __restrict__ tbl, long long n, int bits,
                       const long long* __restrict__ keys, long long n_keys,
                       const unsigned char* __restrict__ q_ok,
                       long long* __restrict__ lo_out,
                       long long* __restrict__ hi_out,
                       int* __restrict__ unc_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long word = word_of(__ldg(queries + i));
    const int4* r = tbl + row_of(word, bits) * 4;
    const int4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2),
               d = __ldg(r + 3);
    // a = c0..c3, b = c4..c7, c = c8..c11, d = c12..c15
    const int deltas[kSlots / 2] = {a.w, b.x, b.y, b.z};
    const int lows[kSlots] = {b.w, c.x, c.y, c.z, c.w, d.x, d.y, d.z};
    const int cnt = a.y & (kEscape - 1);
    const unsigned int t_base = static_cast<unsigned int>(a.z);
    int lt = 0, eq = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const unsigned long long slot =
          slot_word(t_base, deltas[s / 2], s, lows[s]);
      const bool in_run = s < cnt;
      lt += in_run && slot < word;
      eq += in_run && slot == word;
    }
    const bool covered = a.y < kEscape;
    long long lo = static_cast<long long>(a.x) + (covered ? lt : 0);
    long long hi = lo + (covered ? eq : 0);
    if (kTier2) {
      if (!covered && cnt > 0 && q_ok[i])
        exact_bounds(keys, n_keys, a.x, static_cast<long long>(a.x) + cnt,
                     word, lo, hi);
    } else {
      unc_out[i] = covered ? 0 : cnt;
    }
    lo_out[i] = lo;
    hi_out[i] = hi;
  }
}

template <bool kTier2>
__global__ void __launch_bounds__(kMaxThreads)
    window_join_kernel(const long long* __restrict__ keys, long long n_keys,
                       const int* __restrict__ pstart,
                       const long long* __restrict__ queries, long long n,
                       int prefix_bits, int window,
                       const unsigned char* __restrict__ q_ok,
                       long long* __restrict__ lo_out,
                       long long* __restrict__ hi_out,
                       int* __restrict__ unc_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long word = word_of(__ldg(queries + i));
    const unsigned int p =
        static_cast<unsigned int>(word >> (64 - prefix_bits));
    const long long start = __ldg(pstart + p), end = __ldg(pstart + p + 1);
    const long long pos0 = start / window * window;
    const bool covered = end <= pos0 + 2ll * window;
    long long lo = start, hi = start;
    if (covered) {
      // the run's slots only: independent 8 B loads
      int lt = 0, eq = 0;
      const long long stop = min(end, n_keys);
      for (long long k = start; k < stop; ++k) {
        const unsigned long long x = word_of(__ldg(keys + k));
        lt += x < word;
        eq += x == word;
      }
      lo = start + lt;
      hi = word == kAllOnes ? min(pos0 + 2ll * window, n_keys) : lo + eq;
    }
    if (kTier2) {
      if (!covered && q_ok[i])
        exact_bounds(keys, n_keys, start, end, word, lo, hi);
    } else {
      unc_out[i] = covered ? 0 : static_cast<int>(end - start);
    }
    lo_out[i] = lo;
    hi_out[i] = hi;
  }
}

bool launch_ok(int threads, int blocks) {
  return threads > 0 && threads % 32 == 0 && threads <= kMaxThreads &&
         blocks > 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  queries: int64 keys [n];
// lo, hi: int64 [n]; uncovered: int32 [n]; q_ok: bool [n]; keys: the
// sorted, sentinel-padded int64 index keys [n_keys]; all contiguous on
// `device`.  q_ok null: the lookup, which writes lo, hi and uncovered
// (keys may be null for bucket_join); q_ok set: tier 2, which also needs
// the keys and writes only lo and hi (uncovered may be null).  Each
// launches on `stream` of `device` without synchronising, leaves the
// caller's current device as it was, and returns cudaGetLastError() of
// the launch (0 on success; n <= 0 launches nothing).  The grid
// (threads, blocks) comes from ops/join_cuda.py:launch_config.

// tbl: int32 [2^bits, 8], 32 B aligned.
extern "C" int kslam_sector_join(const void* queries, const void* tbl,
                                 const void* keys, long long n_keys,
                                 const void* q_ok, void* lo, void* hi,
                                 void* uncovered, long long n, int bits,
                                 int threads, int blocks, int device,
                                 void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  const bool tier2 = q_ok != nullptr;
  if (bits < 1 || bits > 32 || !launch_ok(threads, blocks) ||
      (tier2 ? keys == nullptr || n_keys < 1 : uncovered == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tbl) % 32 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto* kernel =
      tier2 ? &sector_join_kernel<true> : &sector_join_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(queries), static_cast<const int4*>(tbl),
      n, bits, static_cast<const long long*>(keys), n_keys,
      static_cast<const unsigned char*>(q_ok), static_cast<long long*>(lo),
      static_cast<long long*>(hi), static_cast<int*>(uncovered));
  return static_cast<int>(cudaGetLastError());
}

// tbl: int32 [2^bits, 16], 64 B aligned.
extern "C" int kslam_bucket_join(const void* queries, const void* tbl,
                                 const void* keys, long long n_keys,
                                 const void* q_ok, void* lo, void* hi,
                                 void* uncovered, long long n, int bits,
                                 int threads, int blocks, int device,
                                 void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  const bool tier2 = q_ok != nullptr;
  if (bits < 1 || bits > 32 || !launch_ok(threads, blocks) ||
      (tier2 ? keys == nullptr || n_keys < 1 : uncovered == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tbl) % 64 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto* kernel =
      tier2 ? &bucket_join_kernel<true> : &bucket_join_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(queries), static_cast<const int4*>(tbl),
      n, bits, static_cast<const long long*>(keys), n_keys,
      static_cast<const unsigned char*>(q_ok), static_cast<long long*>(lo),
      static_cast<long long*>(hi), static_cast<int*>(uncovered));
  return static_cast<int>(cudaGetLastError());
}

// pstart: int32 [2^prefix_bits + 1]; window: w.
extern "C" int kslam_window_join(const void* keys, long long n_keys,
                                 const void* pstart, const void* queries,
                                 const void* q_ok, void* lo, void* hi,
                                 void* uncovered, long long n,
                                 int prefix_bits, int window, int threads,
                                 int blocks, int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  const bool tier2 = q_ok != nullptr;
  if (prefix_bits < 1 || prefix_bits > 31 || window < 2 ||
      window > kMaxWindow || (window & (window - 1)) != 0 ||
      n_keys % window != 0 || n_keys < 2ll * window ||
      !launch_ok(threads, blocks) || (!tier2 && uncovered == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel =
      tier2 ? &window_join_kernel<true> : &window_join_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n_keys,
      static_cast<const int*>(pstart), static_cast<const long long*>(queries),
      n, prefix_bits, window, static_cast<const unsigned char*>(q_ok),
      static_cast<long long*>(lo), static_cast<long long*>(hi),
      static_cast<int*>(uncovered));
  return static_cast<int>(cudaGetLastError());
}
