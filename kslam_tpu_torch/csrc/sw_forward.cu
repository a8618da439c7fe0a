// Batched local Smith-Waterman forward pass (affine gaps) for Hopper.
//
// Replaces the Pallas TPU kernel kslam_tpu/ops/sw_pallas.py
// (_sw_kernel / _sw_kernel_body).  Per alignment row t it returns
//   out[0][t] score, out[1][t] ref end column (-1 when score == 0),
//   out[2][t] query end row (0 when score == 0),
// with the reference tie-break (max score, then smallest ref column j,
// then smallest query row i) through the TPU kernel's packed int32 key
//   key = (h << 20) + ((1023 - j) << 10) + (1023 - i) - (2^20 - 1),
// so score-0 cells never beat the zero initial key.  Rows t >= *n_valid
// write (0, -1, 0) and skip the DP.
//
// Codes: A/C/T/G = 0..3, N = 4; N scores 0 against everything.
// Recurrence per cell (i, j), exactly the TPU kernel's:
//   h'   = max(diag + s, E[i], 0)             E from column j-1
//   H    = max(h', F)                         F from rows above, column j
//   F'   = max(h' - go, F - ge)               F of row i+1
//   E[i] = max(H - go, E[i] - ge)             no zero clamp (never wins)
//
// What bounds it: integer work, ~8.5 int32 operations per cell; the bytes
// (codes in, 12 B per alignment out) are three orders of magnitude
// below the card's memory rate.  The design keeps every DP value in
// registers and updates each cell with a few three-operand DPX max ops:
//
// * A group of G threads (a power of two <= 32, inside one warp) per
//   alignment.  Thread p holds query rows p*R .. p*R+R-1 in registers:
//   their score selectors, H and E.  G*R >= Lq; rows >= Lq are N and need
//   no predicate (a trailing N cell only ties a cell at a smaller column,
//   or row, which the tie-break prefers).  G*R <= 1024 keeps the row part
//   of the key >= 0.
// * A wavefront over ref columns: at step s thread p updates column
//   j = s - p, taking H and F of the row above (thread p-1's last row,
//   made at step s-1) through __shfl_up_sync and keeping the H above at
//   column j-1 (diag_top) from its previous step.  Nothing goes through
//   device memory between rows.
// * Codes are int32, row-major, as the callers hold them.  The block
//   stages its alignments' ref rows into shared memory once, as one
//   32-bit score word per column; the score of a cell is one byte
//   permute of that word by the row's selector (prmt), with N scoring 0.
//   Scores outside int8 take a compare-and-select path instead.
// * Each thread keeps the max of its own keys; the group reduces them
//   with __shfl_xor_sync at the end (max is associative: exact).
//
// Limits (checked by the wrapper): Lq, Lr <= 1024, match * Lq <= 2047.
// The launch configuration (G, R, threads per block, grid, shared
// memory) is chosen by ops/sw_cuda.py:launch_config.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kMaxThreads = 128;

// Score word of one ref column.  Byte path: byte c (c = 0..3) holds the
// score of query code c against this column (match or -mismatch), bytes
// of an N column are 0, and query code N selects byte 4 of the permute,
// which is 0.  Wide path: the ref code itself.
template <bool kByte>
__device__ __forceinline__ uint32_t column_word(int rc, uint32_t mm_rep,
                                                uint32_t match_b) {
  if (!kByte) return static_cast<uint32_t>(rc);
  if (rc >= 4) return 0u;
  const int sh = rc << 3;
  return (mm_rep & ~(0xFFu << sh)) | (match_b << sh);
}

// Selector of a query row: byte-permute control that picks byte `qc` and
// fills the three upper bytes with its sign (bit 3 of each nibble).
__device__ __forceinline__ uint32_t row_selector(int qc) {
  const uint32_t c = static_cast<uint32_t>(qc) & 7u;
  return c | ((c | 8u) * 0x1110u);
}

// prmt.b32 d, word, 0, sel in its default mode, whose selector nibbles
// honour bit 3 (replicate the byte's sign); __byte_perm is documented
// with 3-bit selectors and the compiler clears that bit.
__device__ __forceinline__ int permute_signed(uint32_t word, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(word), "r"(0u), "r"(sel));
  return static_cast<int>(d);
}

template <bool kByte>
__device__ __forceinline__ int cell_score(uint32_t word, uint32_t sel,
                                          int match, int mismatch) {
  if (kByte) return permute_signed(word, sel);
  const int rc = static_cast<int>(word);
  const int qc = static_cast<int>(sel);
  return (qc == 4 || rc == 4) ? 0 : (qc == rc ? match : -mismatch);
}

template <int R, bool kByte>
__global__ void __launch_bounds__(kMaxThreads)
sw_group_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                const int32_t* __restrict__ n_valid,
                int32_t* __restrict__ out, int b, int lq, int lr,
                int log_g, int stride, int match, int mismatch, int go,
                int ge) {
  extern __shared__ uint32_t cols[];            // [per_block][stride]
  const int g = 1 << log_g;
  const int per_block = blockDim.x >> log_g;
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
    for (int a = warp; a < n_here; a += n_warps) {
      const int32_t* src = r + static_cast<size_t>(a0 + a) * lr;
      uint32_t* dst = cols + a * stride;
      if (vec) {
        const int4* src4 = reinterpret_cast<const int4*>(src);
        for (int v = lane; v < lr / 4; v += 32) {
          const int4 x = __ldg(src4 + v);
          dst[4 * v] = column_word<kByte>(x.x, mm_rep, match_b);
          dst[4 * v + 1] = column_word<kByte>(x.y, mm_rep, match_b);
          dst[4 * v + 2] = column_word<kByte>(x.z, mm_rep, match_b);
          dst[4 * v + 3] = column_word<kByte>(x.w, mm_rep, match_b);
        }
      } else {
        for (int j = lane; j < lr; j += 32)
          dst[j] = column_word<kByte>(src[j], mm_rep, match_b);
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
      out[2 * b + t] = 0;
    }
    return;
  }
  const unsigned lane_in_warp = threadIdx.x & 31;
  const unsigned mask = (g == 32 ? 0xFFFFFFFFu : ((1u << g) - 1u))
                        << (lane_in_warp & ~static_cast<unsigned>(g - 1));

  // query profile of this thread's rows; rows >= lq are N
  uint32_t sel[R];
  int h[R], e[R];
  const int32_t* qt = q + static_cast<size_t>(t) * lq;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = p * R + k;
    const int qc = i < lq ? qt[i] : 4;
    sel[k] = kByte ? row_selector(qc) : static_cast<uint32_t>(qc);
    h[k] = 0;
    e[k] = 0;
  }
  const uint32_t* my_cols = cols + slot * stride;
  // query-row part of the key for row p*R: (1023 - p*R) - (2^20 - 1)
  const int row_key = (1023 - p * R) - ((1 << 20) - 1);
  int best = 0;                                 // max packed key
  int out_h = 0, out_f = kNeg;                  // handed to thread p+1
  int diag_top = 0;                             // H[p*R - 1][j - 1]
  const int steps = lr + g - 1;
  for (int s = 0; s < steps; ++s) {
    int top_h = __shfl_up_sync(mask, out_h, 1, g);
    int f = __shfl_up_sync(mask, out_f, 1, g);
    if (p == 0) {
      top_h = 0;
      f = kNeg;
    }
    const int j = s - p;
    if (static_cast<unsigned>(j) < static_cast<unsigned>(lr)) {
      const uint32_t word = my_cols[j];
      int diag = diag_top;
      diag_top = top_h;
      int cm = INT_MIN;                         // max of (H << 20) - k
#pragma unroll
      for (int k = 0; k < R; k += 2) {
        const int s0 = cell_score<kByte>(word, sel[k], match, mismatch);
        const int hp0 = __viaddmax_s32_relu(diag, s0, e[k]);
        diag = h[k];
        const int h0 = max(hp0, f);
        f = __viaddmax_s32(hp0, -go, f - ge);
        e[k] = __viaddmax_s32(h0, -go, e[k] - ge);
        h[k] = h0;
        const int s1 = cell_score<kByte>(word, sel[k + 1], match, mismatch);
        const int hp1 = __viaddmax_s32_relu(diag, s1, e[k + 1]);
        diag = h[k + 1];
        const int h1 = max(hp1, f);
        f = __viaddmax_s32(hp1, -go, f - ge);
        e[k + 1] = __viaddmax_s32(h1, -go, e[k + 1] - ge);
        h[k + 1] = h1;
        cm = __vimax3_s32(cm, (h0 << 20) - k, (h1 << 20) - (k + 1));
      }
      best = max(best, cm + (((1023 - j) << 10) + row_key));
      out_h = h[R - 1];
      out_f = f;
    }
  }
  for (int o = g >> 1; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(mask, best, o, g));
  if (p == 0) {
    const int k2 = best + ((1 << 20) - 1);
    const int score = k2 >> 20;
    const bool pos = score > 0;
    out[t] = score;
    out[b + t] = pos ? 1023 - ((k2 >> 10) & 1023) : -1;
    out[2 * b + t] = pos ? 1023 - (k2 & 1023) : 0;
  }
}

template <int R, bool kByte>
cudaError_t launch_one(const void* q, const void* r, const void* n_valid,
                       void* out, int b, int lq, int lr, int log_g,
                       int stride, int threads, int blocks, int smem,
                       int match, int mismatch, int go, int ge,
                       cudaStream_t stream) {
  auto kernel = sw_group_kernel<R, kByte>;
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

template <int R>
cudaError_t launch_rows(const void* q, const void* r, const void* n_valid,
                        void* out, int b, int lq, int lr, int log_g,
                        int stride, int threads, int blocks, int smem,
                        int match, int mismatch, int go, int ge,
                        cudaStream_t stream) {
  // int8 score words when match and -mismatch fit a signed byte
  if (match >= -128 && match <= 127 && -mismatch >= -128 && -mismatch <= 127)
    return launch_one<R, true>(q, r, n_valid, out, b, lq, lr, log_g, stride,
                               threads, blocks, smem, match, mismatch, go, ge,
                               stream);
  return launch_one<R, false>(q, r, n_valid, out, b, lq, lr, log_g, stride,
                              threads, blocks, smem, match, mismatch, go, ge,
                              stream);
}

// Makes `device` current for a launch and gives the caller back its own
// current device afterwards: PyTorch's "cuda" means the current device,
// so a launch on another card of a mesh must not change it.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes).  q [b, lq] and r [b, lr] are
// row-major int32 codes; out is int32 [3, b].  group = G (a power of two
// <= 32), rows = R (one of the instantiated row counts), stride = the
// shared-memory words per alignment, threads / blocks / smem the launch.
// Launches on `stream` of `device` without synchronising, and leaves the
// caller's current device as it was; returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int kslam_sw_forward(const void* q, const void* r,
                                const void* n_valid, void* out, int b,
                                int lq, int lr, int group, int rows,
                                int stride, int threads, int blocks,
                                int smem, int match, int mismatch, int go,
                                int ge, int device, void* stream) {
  const DeviceGuard guard(device);
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
    err = launch_rows<RR>(q, r, n_valid, out, b, lq, lr, log_g, stride,    \
                          threads, blocks, smem, match, mismatch, go, ge,  \
                          st);                                             \
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
