// Batched local Smith-Waterman (affine gaps) for Hopper: the forward pass
// alone, and the forward and reverse passes fused into one launch.
//
// Forward pass (kAlign = false): replaces the Pallas TPU kernel
// kslam_tpu/ops/sw_pallas.py (_sw_kernel / _sw_kernel_body).  Per
// alignment row t it returns
//   out[0][t] score, out[1][t] ref end column (-1 when score == 0),
//   out[2][t] query end row (0 when score == 0),
// with the reference tie-break (max score, then smallest ref column j,
// then smallest query row i) through the TPU kernel's packed int32 key
//   key = (h << 20) + ((1023 - j) << 10) + (1023 - i) - (2^20 - 1),
// so score-0 cells never beat the zero initial key.  Rows t >= *n_valid
// write (0, -1, 0) and skip the DP.
//
// Fused alignment (kAlign = true, sw_align): replaces
// kslam_tpu/ops/sw_pallas.py:188-205 (sw_align_batch: forward pass ->
// _reverse_gather of both prefixes -> forward pass again) and, on the
// device pipeline, kslam_tpu/ops/sw.py:277-292 (the same on fixed flips
// with masks).  It writes out[0..4][t] = score, ref_begin, ref_end,
// query_begin, query_end (window coordinates; (0, -1, -1, 0, 0) when the
// score is 0 or t >= *n_valid), in one launch from one staging:
// * while a warp stages an alignment's ref row it also finds the row's
//   first and last non-N column c0, c1 (warp reductions) and stores them
//   beside the column words;
// * the forward pass sweeps columns c0..c1 only.  Leading all-N columns
//   leave H = 0 and E <= 0 (which never wins h' = max(.., 0)); a trailing
//   all-N cell can at best tie a cell at a smaller column, which the
//   tie-break keeps.  The key still uses the true column j, so every
//   output equals the untrimmed pass's;
// * the group decodes (score, ref_end, read_end) on every lane and, when
//   the score is > 0, runs the wavefront again from the same shared
//   memory: reverse column j' reads column ref_end - j' for
//   j' = 0 .. ref_end - c0, reverse row i' holds query row read_end - i'
//   (N past read_end).  Only threads p < ceil((read_end + 1) / R) hold
//   live rows, so the reverse pass takes (ref_end - c0 + 1) + that - 1
//   steps.  Then ref_begin = ref_end - rev_ref_end and query_begin =
//   read_end - rev_read_end, as sw_pallas.py:201-203 computes them.  The
//   JAX reverse pass has the live prefix behind leading N or before
//   trailing N; leading N stays 0 and trailing N only ties, so the
//   trimmed rectangle translated to 0 has the same arg-max.
// It removes the composition's second staging, its [B, L] gathers and
// flips in device memory between the launches, and the dead cells of
// both passes (N-padded columns; reverse rows past read_end).
//
// Codes: A/C/T/G = 0..3, N = 4; N scores 0 against everything.
// Recurrence per cell (i, j), exactly the TPU kernel's:
//   h'   = max(diag + s, E[i], 0)             E from column j-1
//   H    = max(h', F)                         F from rows above, column j
//   F'   = max(h' - go, F - ge)               F of row i+1
//   E[i] = max(H - go, E[i] - ge)             no zero clamp (never wins)
//
// What bounds both: integer work, 8.5 int32 instructions per live cell;
// the bytes (codes in, 12 or 20 B per alignment out) are three orders
// of magnitude below the card's memory rate.  The design keeps every DP
// value in registers and updates each cell with a few three-operand DPX
// max ops:
//
// * A group of G threads (a power of two <= 32, inside one warp) per
//   alignment.  Thread p holds query rows p*R .. p*R+R-1 in registers:
//   their score selectors, H and E.  G*R >= Lq; rows >= Lq are N and need
//   no predicate (a trailing N cell only ties a cell at a smaller column,
//   or row, which the tie-break prefers).  G*R <= 1024 keeps the row part
//   of the key >= 0.
// * A wavefront over ref columns: at step s thread p updates pass column
//   jj = s - p, taking H and F of the row above (thread p-1's last row,
//   made at step s-1) through __shfl_up_sync and keeping the H above at
//   column jj-1 (diag_top) from its previous step.  Nothing goes through
//   device memory between rows.  Every lane of a group runs the same
//   number of steps (from values the group shares), as the group-masked
//   shuffles need; groups of one warp may run different counts, and the
//   warp then waits for its slowest group.
// * Codes are int32, row-major, as the callers hold them.  The block
//   stages its alignments' ref rows into shared memory once, as one
//   32-bit score word per column; the score of a cell is one byte
//   permute of that word by the row's selector (prmt), with N scoring 0.
//   Scores outside int8 take a compare-and-select path instead.
// * Each thread keeps the max of its own keys; the group reduces them
//   with __shfl_xor_sync at the end (max is associative: exact), which
//   leaves the result on every lane.
//
// The group wavefront (group_pass, the score words, the key) lives in
// sw_group.cuh, shared with sam.cu's sam_cigar.
//
// Limits (checked by the wrapper): Lq, Lr <= 1024, match * Lq <= 2047.
// The launch configuration (G, R, threads per block, grid, shared
// memory) is chosen by ops/sw_cuda.py:launch_config.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "sw_group.cuh"

namespace {

using namespace kslam;

constexpr int kMaxThreads = 128;

template <int R, bool kByte, bool kAlign>
__global__ void __launch_bounds__(kMaxThreads)
sw_group_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                const int32_t* __restrict__ n_valid,
                int32_t* __restrict__ out, int b, int lq, int lr,
                int log_g, int stride, int match, int mismatch, int go,
                int ge) {
  // [per_block][stride] score words, then (kAlign) [per_block][2] column
  // extents (c0, c1); c0 = lr, c1 = -1 for a row without a non-N column
  extern __shared__ uint32_t cols[];
  const int g = 1 << log_g;
  const int per_block = blockDim.x >> log_g;
  int* extents = reinterpret_cast<int*>(cols + per_block * stride);
  const int a0 = blockIdx.x * per_block;
  const int n_here = min(per_block, b - a0);
  const uint32_t mm_rep = (static_cast<uint32_t>(-mismatch) & 0xFFu) *
                          0x01010101u;
  const uint32_t match_b = static_cast<uint32_t>(match) & 0xFFu;

  // Stage the block's ref rows as score words, one warp per row, with
  // 16-byte loads where the rows are 16-byte aligned.
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const bool vec = (lr % 4) == 0 &&
                     (reinterpret_cast<uintptr_t>(r) & 15u) == 0;
    for (int a = warp; a < n_here; a += n_warps) {  // uniform in the warp
      const int32_t* src = r + static_cast<size_t>(a0 + a) * lr;
      uint32_t* dst = cols + a * stride;
      int lo = lr, hi = -1;                     // this lane's non-N extent
      if (vec) {
        const int4* src4 = reinterpret_cast<const int4*>(src);
        for (int v = lane; v < lr / 4; v += 32) {
          const int4 x = __ldg(src4 + v);
          dst[4 * v] = column_word<kByte>(x.x, mm_rep, match_b);
          dst[4 * v + 1] = column_word<kByte>(x.y, mm_rep, match_b);
          dst[4 * v + 2] = column_word<kByte>(x.z, mm_rep, match_b);
          dst[4 * v + 3] = column_word<kByte>(x.w, mm_rep, match_b);
          if (kAlign) {
            const int c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (c[u] < 4) {
                lo = min(lo, 4 * v + u);
                hi = max(hi, 4 * v + u);
              }
            }
          }
        }
      } else {
        for (int j = lane; j < lr; j += 32) {
          const int rc = src[j];
          dst[j] = column_word<kByte>(rc, mm_rep, match_b);
          if (kAlign && rc < 4) {
            lo = min(lo, j);
            hi = max(hi, j);
          }
        }
      }
      if (kAlign) {
        lo = __reduce_min_sync(0xFFFFFFFFu, lo);
        hi = __reduce_max_sync(0xFFFFFFFFu, hi);
        if (lane == 0) {
          extents[2 * a] = lo;
          extents[2 * a + 1] = hi;
        }
      }
    }
  }
  __syncthreads();

  const int slot = threadIdx.x >> log_g;
  const int p = threadIdx.x & (g - 1);
  const int t = a0 + slot;
  if (t >= b) return;                           // whole groups only
  if (t >= *n_valid) {                          // uniform in the group
    if (p == 0) {
      out[t] = 0;
      out[b + t] = -1;
      out[2 * b + t] = kAlign ? -1 : 0;
      if (kAlign) {
        out[3 * b + t] = 0;
        out[4 * b + t] = 0;
      }
    }
    return;
  }
  const unsigned mask = group_mask(g);

  // query profile of this thread's rows; rows >= lq are N
  uint32_t sel[R];
  int h[R], e[R];
  const int32_t* qt = q + static_cast<size_t>(t) * lq;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = p * R + k;
    sel[k] = selector<kByte>(i < lq ? qt[i] : 4);
    h[k] = 0;
    e[k] = 0;
  }
  const uint32_t* my_cols = cols + slot * stride;
  const int c0 = kAlign ? extents[2 * slot] : 0;
  const int ncols = kAlign ? extents[2 * slot + 1] - c0 + 1 : lr;
  const KeyEnds fwd = decode(group_pass<R, kByte, 1>(
      my_cols + c0, c0, ncols, g, sel, h, e, p, g, mask, match, mismatch, go,
      ge));
  if (!kAlign) {
    if (p == 0) {
      out[t] = fwd.score;
      out[b + t] = fwd.col;
      out[2 * b + t] = fwd.row;
    }
    return;
  }

  int ref_begin = -1, query_begin = 0;
  if (fwd.score > 0) {                          // uniform in the group
    // reverse row i' = p*R + k holds query row read_end - i'
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = p * R + k;
      sel[k] = selector<kByte>(i <= fwd.row ? qt[fwd.row - i] : 4);
      h[k] = 0;
      e[k] = 0;
    }
    const int lanes = (fwd.row + R) / R;        // ceil((read_end + 1) / R)
    const KeyEnds rev = decode(group_pass<R, kByte, -1>(
        my_cols + fwd.col, 0, fwd.col - c0 + 1, lanes, sel, h, e, p, g, mask,
        match, mismatch, go, ge));
    ref_begin = fwd.col - rev.col;
    query_begin = fwd.row - rev.row;
  }
  if (p == 0) {
    out[t] = fwd.score;
    out[b + t] = ref_begin;
    out[2 * b + t] = fwd.col;
    out[3 * b + t] = query_begin;
    out[4 * b + t] = fwd.row;
  }
}

template <int R, bool kByte, bool kAlign>
cudaError_t launch_one(const void* q, const void* r, const void* n_valid,
                       void* out, int b, int lq, int lr, int log_g,
                       int stride, int threads, int blocks, int smem,
                       int match, int mismatch, int go, int ge,
                       cudaStream_t stream) {
  auto kernel = sw_group_kernel<R, kByte, kAlign>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(n_valid), static_cast<int32_t*>(out), b,
      lq, lr, log_g, stride, match, mismatch, go, ge);
  return cudaGetLastError();
}

template <int R, bool kAlign>
cudaError_t launch_rows(const void* q, const void* r, const void* n_valid,
                        void* out, int b, int lq, int lr, int log_g,
                        int stride, int threads, int blocks, int smem,
                        int match, int mismatch, int go, int ge,
                        cudaStream_t stream) {
  // int8 score words when match and -mismatch fit a signed byte
  if (match >= -128 && match <= 127 && -mismatch >= -128 && -mismatch <= 127)
    return launch_one<R, true, kAlign>(q, r, n_valid, out, b, lq, lr, log_g,
                                       stride, threads, blocks, smem, match,
                                       mismatch, go, ge, stream);
  return launch_one<R, false, kAlign>(q, r, n_valid, out, b, lq, lr, log_g,
                                      stride, threads, blocks, smem, match,
                                      mismatch, go, ge, stream);
}

template <bool kAlign>
int launch_entry(const void* q, const void* r, const void* n_valid,
                 void* out, int b, int lq, int lr, int group, int rows,
                 int stride, int threads, int blocks, int smem, int match,
                 int mismatch, int go, int ge, int device, void* stream) {
  const kslam::DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  int log_g = 0;
  while ((1 << log_g) < group) ++log_g;
  if ((1 << log_g) != group || group > 32 || group * rows < lq ||
      group * rows > 1024 || threads % 32 != 0 || threads > kMaxThreads ||
      stride < lr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KSLAM_ROWS(RR)                                                     \
  case RR:                                                                 \
    err = launch_rows<RR, kAlign>(q, r, n_valid, out, b, lq, lr, log_g,    \
                                  stride, threads, blocks, smem, match,    \
                                  mismatch, go, ge, st);                   \
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
      err = cudaErrorInvalidValue;
  }
#undef KSLAM_ROWS
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  q [b, lq] and r [b, lr] are
// row-major int32 codes; out is int32 [3, b] (kslam_sw_forward) or
// [5, b] (kslam_sw_align).  group = G (a power of two <= 32), rows = R
// (one of the instantiated row counts), stride = the shared-memory words
// per alignment's columns, threads / blocks / smem the launch (smem
// includes the two extent words per alignment for kslam_sw_align).
// Each launches on `stream` of `device` without synchronising, and
// leaves the caller's current device as it was; returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int kslam_sw_forward(const void* q, const void* r,
                                const void* n_valid, void* out, int b,
                                int lq, int lr, int group, int rows,
                                int stride, int threads, int blocks,
                                int smem, int match, int mismatch, int go,
                                int ge, int device, void* stream) {
  return launch_entry<false>(q, r, n_valid, out, b, lq, lr, group, rows,
                             stride, threads, blocks, smem, match, mismatch,
                             go, ge, device, stream);
}

extern "C" int kslam_sw_align(const void* q, const void* r,
                              const void* n_valid, void* out, int b, int lq,
                              int lr, int group, int rows, int stride,
                              int threads, int blocks, int smem, int match,
                              int mismatch, int go, int ge, int device,
                              void* stream) {
  return launch_entry<true>(q, r, n_valid, out, b, lq, lr, group, rows,
                            stride, threads, blocks, smem, match, mismatch,
                            go, ge, device, stream);
}
