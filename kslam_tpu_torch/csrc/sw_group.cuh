// The group wavefront of the port's SW kernels, shared by sw_forward.cu
// (sw_forward, sw_align) and sam.cu (sam_cigar's forward and reverse
// passes).  See sw_forward.cu's header for the design: a group of G
// lanes an alignment, R query rows a lane in registers, the row above
// handed down by __shfl_up_sync, cells scored by one byte permute of a
// per-column score word in shared memory and updated with DPX max ops,
// the winner chosen by the packed key
//   key = (h << 20) + ((1023 - j) << 10) + (1023 - i) - (2^20 - 1)
// (max score, then smallest column j, then smallest row i).
#pragma once

#include <climits>
#include <cstdint>

namespace kslam {

constexpr int kNeg = -(1 << 30);
constexpr int kKeyBias = (1 << 20) - 1;

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

template <bool kByte>
__device__ __forceinline__ uint32_t selector(int qc) {
  return kByte ? row_selector(qc) : static_cast<uint32_t>(qc);
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

// One wavefront pass of a group over `ncols` columns: pass column jj reads
// the score word col_base[kDir * jj] and has key column key_col0 + jj.
// `lanes` threads of the group hold live rows (the rest hold N rows and
// run along); the group runs ncols + lanes - 1 steps.  h and e must be
// zero and sel loaded.  Returns the group's max key on every lane.
template <int R, bool kByte, int kDir>
__device__ __forceinline__ int group_pass(
    const uint32_t* col_base, int key_col0, int ncols, int lanes,
    const uint32_t (&sel)[R], int (&h)[R], int (&e)[R], int p, int g,
    unsigned mask, int match, int mismatch, int go, int ge) {
  // column and row parts of the key for column key_col0, row p*R
  const int col_row_key = ((1023 - key_col0) << 10) + (1023 - p * R) -
                          kKeyBias;
  int best = 0;                                 // max packed key
  int out_h = 0, out_f = kNeg;                  // handed to thread p+1
  int diag_top = 0;                             // H[p*R - 1][jj - 1]
  const int steps = ncols > 0 ? ncols + lanes - 1 : 0;
  for (int s = 0; s < steps; ++s) {
    int top_h = __shfl_up_sync(mask, out_h, 1, g);
    int f = __shfl_up_sync(mask, out_f, 1, g);
    if (p == 0) {
      top_h = 0;
      f = kNeg;
    }
    const int jj = s - p;
    if (static_cast<unsigned>(jj) < static_cast<unsigned>(ncols)) {
      const uint32_t word = col_base[kDir * jj];
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
      best = max(best, cm + (col_row_key - (jj << 10)));
      out_h = h[R - 1];
      out_f = f;
    }
  }
  for (int o = g >> 1; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(mask, best, o, g));
  return best;
}

struct KeyEnds {
  int score, col, row;                          // col -1, row 0 at score 0
};

__device__ __forceinline__ KeyEnds decode(int best) {
  const int k2 = best + kKeyBias;
  const int score = k2 >> 20;
  const bool pos = score > 0;
  return {score, pos ? 1023 - ((k2 >> 10) & 1023) : -1,
          pos ? 1023 - (k2 & 1023) : 0};
}

// The shuffle mask of the group of g lanes (a power of two <= 32) that
// holds this lane.
__device__ __forceinline__ unsigned group_mask(int g) {
  const unsigned lane = threadIdx.x & 31;
  return (g == 32 ? 0xFFFFFFFFu : ((1u << g) - 1u))
         << (lane & ~static_cast<unsigned>(g - 1));
}

}  // namespace kslam
