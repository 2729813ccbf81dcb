// Pieces shared by the banded-DP kernels: constants, the one-prmt
// substitution, the choice between a kernel's narrow and wide build, and
// when the one-pass kernels may skip trailing sentinel rows.
//
// The narrow build keeps each target code as a prmt byte selector with sign
// replication and each read row as a word of four int8 scores (match at the
// row's code, mismatch elsewhere), so a cell's substitution score is one
// prmt. The wide build compares the codes and selects the score.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace svjt {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kRowMask = (1 << 15) - 1;  // row field of a packed best-cell key

// int32 score of a target code for the row's score word: the selector's
// byte 0 picks the code's byte of (lo, hi), bytes 1-3 replicate its sign.
__device__ __forceinline__ int substitution(uint32_t lo, uint32_t hi,
                                            uint32_t sel) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t target_selector(int code) {
  const uint32_t b = (unsigned)code < 8u ? (uint32_t)code : 4u;
  return b * 0x1111u + 0x8880u;
}

// Scores of codes 0-3 against read code `code` (codes >= 4 match nothing).
__device__ __forceinline__ uint32_t row_scores(int code, uint32_t mm4,
                                               uint32_t flip) {
  return (unsigned)code < 4u ? mm4 ^ (flip << (8 * code)) : mm4;
}

// A read row's word and a target code's word: the narrow build's score
// word and prmt selector, the wide build's codes themselves.
template <bool kWide>
__device__ __forceinline__ uint32_t row_word(int code, uint32_t mm4,
                                             uint32_t flip) {
  if constexpr (kWide) return (uint32_t)code;
  else return row_scores(code, mm4, flip);
}

template <bool kWide>
__device__ __forceinline__ int target_word(int code) {
  if constexpr (kWide) return code;
  else return (int)target_selector(code);
}

// Score of a row word against a target word (codes >= 4 match nothing).
template <bool kWide>
__device__ __forceinline__ int score(uint32_t row, int target, uint32_t mm4,
                                     int match, int mismatch) {
  if constexpr (kWide) return row < 4u && (int)row == target ? match : mismatch;
  else return substitution(row, mm4, (uint32_t)target);
}

inline bool fits_int8(int v) { return -128 <= v && v < 128; }

// Largest score a path over `rows` rows of a `band`-wide band can reach.
// Where mismatch and gap scores are not positive, only matches add, at most
// one per row. Otherwise every step may add the largest score: a path
// takes one diagonal or vertical step per row, and at most band + rows
// horizontal ones (each vertical step moves it one band offset back).
inline long long max_score(int match, int mismatch, int oe, int ext, int rows,
                           int band) {
  if (mismatch <= 0 && oe <= 0 && ext <= 0)
    return (long long)(match > 0 ? match : 0) * rows;
  const int step = match > mismatch ? match : mismatch;
  const int gap = oe > ext ? oe : ext;
  return (long long)(step > gap ? step : gap) * (2LL * rows + band);
}

// The narrow build needs scores below 2^16 for its packed (score, row) key
// and match, mismatch in int8 for its prmt words.
inline bool needs_wide(int match, int mismatch, int oe, int ext, int rows,
                       int band) {
  return max_score(match, mismatch, oe, ext, rows, band) >= (1 << 16) ||
         !fits_int8(match) || !fits_int8(mismatch);
}

// Whether a one-pass kernel may stop after a warp's last non-sentinel read
// row: a sentinel row then leaves every cell below the maximum or equal to
// the same cell a row earlier. A zero gap open (oe = 0) lets such a row
// carry the maximum to a lower band offset, and a positive mismatch or
// extend raises it, so then every row runs.
inline bool rows_skip_exact(int mismatch, int oe, int ext) {
  return mismatch <= 0 && oe < 0 && ext <= 0;
}

}  // namespace svjt
