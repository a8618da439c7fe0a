// The k-mer join's two table lookups for Hopper: bucket_join and
// window_join.  Each returns, for every query key, (lo int64, hi int64,
// uncovered int32) exactly as the plain versions in ops/join.py do.
//
// What they compute.  The reference package's join is XLA ops, not a
// Pallas kernel: on the TPU XLA fuses each lookup into a few passes.
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
//   end = pstart[p + 1], pos0 = (start / w) * w; lt and eq count the
//   sorted index keys below and equal to the query over all 2w slots
//   [pos0, pos0 + 2w) (slots before start hold smaller prefixes, slots
//   from end on larger ones or the all-ones sentinels).  covered =
//   end <= pos0 + 2w; lo = covered ? pos0 + lt : start, hi = covered ?
//   lo + eq : start, uncovered = covered ? 0 : end - start.
// Keys are int64 with the top bit flipped (ops/kmers.py); every compare
// here is on the unsigned word, key ^ 2^63.
//
// What bounds both on the H100: bytes.  bucket_join moves per query its
// 8 B key, one 64 B row (two 32 B sectors) and 20 B of outputs;
// window_join its key, two 4 B pstart entries, 2w keys (16w B) and the
// outputs.  There is no arithmetic to speak of.  The torch versions
// gather the row into a [Q, 16] temporary and then run ~30 passes over
// [Q, 8] int64 temporaries; these kernels read each row once into
// registers and write only the outputs:
// * bucket_join: one thread per query (grid-stride loop).  The row is
//   four independent 16 B read-only loads (ld.global.nc.v4), so a thread
//   has its whole row in flight at once; the table is 64 B aligned (the
//   wrapper checks), so a row is two sectors.  The CDF map is one
//   __umulhi.  The eight slot compares are unrolled in registers.
// * window_join: a group of G = min(w, 32) lanes per query.  Lane l
//   reads keys pos0 + 2(l + G k) and the next one as one 16 B load, for
//   k < w / G steps, so a group reads its 2w keys in coalesced 16 B
//   lanes (w = 16: two queries per warp, 256 B per half-warp).  Each
//   lane packs its counts as lt | eq << 16 (2w <= 2^13) and the group
//   sums them with a shuffle butterfly; its first lane writes.  Queries
//   are dealt to warps in tiles of 32 / G, so every lane of a warp runs
//   the same loop and the shuffles use the full mask.
// Random 64 B rows over a table of up to 4 GiB cost TLB and DRAM page
// misses that the bytes bound does not count.
//
// Limits (checked by the wrapper, ops/join_cuda.py): bits in 1..32;
// prefix_bits in 1..31; w a power of two in 2..4096 with the keys'
// length a multiple of w and >= 2w; the table 64 B aligned and the keys
// 16 B aligned.  A slot past the keys' end counts as neither below nor
// equal (the index carries >= 2w sentinels, so no valid input has one).

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned long long kFlip = 0x8000000000000000ull;
constexpr int kEscape = 1 << 30;
constexpr int kSlots = 8;          // KmerIndex.BUCKET_SLOTS
constexpr int kDeltaBits = 12;     // KmerIndex.BUCKET_DELTA_BITS
constexpr int kMaxThreads = 256;
constexpr int kMaxWindow = 4096;

__device__ __forceinline__ unsigned long long word_of(long long key) {
  return static_cast<unsigned long long>(key) ^ kFlip;
}

__global__ void __launch_bounds__(kMaxThreads)
    bucket_join_kernel(const long long* __restrict__ queries,
                       const int4* __restrict__ tbl, long long n, int bits,
                       long long* __restrict__ lo_out,
                       long long* __restrict__ hi_out,
                       int* __restrict__ unc_out) {
  const unsigned long long last_row = (1ull << bits) - 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long word = word_of(__ldg(queries + i));
    const unsigned int t = static_cast<unsigned int>(word >> 32);
    // v = 2t - floor(t^2 / 2^32) <= 2^32: 2^32 only at t = 2^32 - 1,
    // which the clamp puts in the last row
    const unsigned long long v = 2ull * t - __umulhi(t, t);
    const unsigned long long row = min(v >> (32 - bits), last_row);
    const int4* r = tbl + row * 4;
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
      // the delta word is int32: an arithmetic shift, then the mask
      const unsigned int delta = static_cast<unsigned int>(
          (deltas[s / 2] >> (kDeltaBits * (s % 2))) &
          ((1 << kDeltaBits) - 1));
      const unsigned long long slot =
          (static_cast<unsigned long long>(t_base + delta) << 32) |
          static_cast<unsigned int>(lows[s]);
      const bool in_run = s < cnt;
      lt += in_run && slot < word;
      eq += in_run && slot == word;
    }
    const bool covered = a.y < kEscape;
    const long long lo = static_cast<long long>(a.x) + (covered ? lt : 0);
    lo_out[i] = lo;
    hi_out[i] = lo + (covered ? eq : 0);
    unc_out[i] = covered ? 0 : cnt;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    window_join_kernel(const longlong2* __restrict__ keys2, long long n_keys,
                       const int* __restrict__ pstart,
                       const long long* __restrict__ queries, long long n,
                       int prefix_bits, int window, int group,
                       long long* __restrict__ lo_out,
                       long long* __restrict__ hi_out,
                       int* __restrict__ unc_out) {
  const int lane = threadIdx.x & 31;
  const int member = lane & (group - 1);
  const int per_warp = 32 / group;
  const int steps = window / group;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // warp-uniform loop: tile `base` holds queries base .. base + 32/G - 1
  for (long long base = warp * per_warp; base < n;
       base += warps * per_warp) {
    const long long qi = base + lane / group;
    const bool live = qi < n;
    unsigned int packed = 0;           // lt | eq << 16 of this lane
    long long start = 0, end = 0, pos0 = 0;
    if (live) {
      const unsigned long long word = word_of(__ldg(queries + qi));
      const unsigned int p =
          static_cast<unsigned int>(word >> (64 - prefix_bits));
      start = __ldg(pstart + p);
      end = __ldg(pstart + p + 1);
      pos0 = start / window * window;
      for (int k = 0; k < steps; ++k) {
        const long long pair = pos0 / 2 + member +
                               static_cast<long long>(group) * k;
        if (2 * pair >= n_keys) break;
        const longlong2 kk = __ldg(keys2 + pair);
        const unsigned long long x = word_of(kk.x), y = word_of(kk.y);
        packed += (x < word) + (y < word) +
                  (((x == word) + (y == word)) << 16);
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1)
      packed += __shfl_xor_sync(0xffffffffu, packed, off);
    if (live && member == 0) {
      const bool covered = end <= pos0 + 2ll * window;
      const long long lo = covered ? pos0 + (packed & 0xFFFFu) : start;
      lo_out[qi] = lo;
      hi_out[qi] = covered ? lo + (packed >> 16) : start;
      unc_out[qi] = covered ? 0 : static_cast<int>(end - start);
    }
  }
}

bool launch_ok(int threads, int blocks) {
  return threads > 0 && threads % 32 == 0 && threads <= kMaxThreads &&
         blocks > 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  queries: int64 keys [n];
// lo, hi: int64 [n]; uncovered: int32 [n]; all contiguous on `device`.
// Each launches on `stream` of `device` without synchronising, leaves
// the caller's current device as it was, and returns
// cudaGetLastError() of the launch (0 on success; n <= 0 launches
// nothing).  The grid (threads, blocks) comes from
// ops/join_cuda.py:launch_config.

// tbl: int32 [2^bits, 16], 64 B aligned.
extern "C" int kslam_bucket_join(const void* queries, const void* tbl,
                                 void* lo, void* hi, void* uncovered,
                                 long long n, int bits, int threads,
                                 int blocks, int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  if (bits < 1 || bits > 32 || !launch_ok(threads, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tbl) % 64 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  bucket_join_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(queries), static_cast<const int4*>(tbl),
      n, bits, static_cast<long long*>(lo), static_cast<long long*>(hi),
      static_cast<int*>(uncovered));
  return static_cast<int>(cudaGetLastError());
}

// keys: the sorted, sentinel-padded int64 index keys [n_keys], 16 B
// aligned; pstart: int32 [2^prefix_bits + 1]; window: w; group: G =
// min(w, 32).
extern "C" int kslam_window_join(const void* keys, long long n_keys,
                                 const void* pstart, const void* queries,
                                 void* lo, void* hi, void* uncovered,
                                 long long n, int prefix_bits, int window,
                                 int group, int threads, int blocks,
                                 int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (n <= 0) return 0;
  if (prefix_bits < 1 || prefix_bits > 31 || window < 2 ||
      window > kMaxWindow || (window & (window - 1)) != 0 ||
      group != (window < 32 ? window : 32) || n_keys % window != 0 ||
      n_keys < 2ll * window || !launch_ok(threads, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(keys) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  window_join_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2*>(keys), n_keys,
      static_cast<const int*>(pstart), static_cast<const long long*>(queries),
      n, prefix_bits, window, group, static_cast<long long*>(lo),
      static_cast<long long*>(hi), static_cast<int*>(uncovered));
  return static_cast<int>(cudaGetLastError());
}
