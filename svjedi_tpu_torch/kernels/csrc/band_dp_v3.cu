// Banded affine-gap local alignment, score and end only (the v3 forward pass).
//
// Replaces the Pallas TPU kernel svjedi_tpu/kernels/band_dp_v3.py:_kernel
// (with _kernel_body). Same contract: for each problem p, the windows
// qT[:, p] (bucket rows) and tT[:, p] (bucket + band rows) are int8 codes in
// a transposed (rows, P) layout, with sentinel 4 matching nothing (codes
// outside 0..4 never occur; the kernel scores them like 4). Cell (i, k)
// pairs read row i with target row i + k. Output per problem is (best
// score, qe, te = qe + k): a cell keeps the first row that reaches its best
// (strict >), and among cells tied at the maximum the lowest band offset k
// wins; a problem scoring 0 reports qe = te = -1. prefetch holds [n_valid]
// ++ one row bound per 128 problems (the JAX scalar-prefetch vector):
// problem p runs min(round_up(bound[p / 128], 8), bucket) rows, and
// problems at index >= n_valid are written (0, -1, -1).
//
// What bounds it on the H100: integer issue. A row costs each problem one
// byte of q and one of t, while each of its band cells needs 9 int32
// operations as Hopper issues them:
//   V      = max(H[k+1] + oe, V[k+1] + ext)    add + viaddmax
//   sub    = score of (q_i, t_{i+k})           prmt (one byte lookup)
//   htmp   = max(H + sub, V, 0)                viaddmax_relu
//   run    = max(run, htmp + oe - ext*(k+1))   viaddmax (lane-local F scan)
//   H      = max(htmp, F), F closed from the
//            lane-local and the cross-lane part viaddmax + viaddmax
//   best score and its row                     imad + max (packed key)
// so the bound is cells * 9 / (132 SMs * 64 int32 lanes * SM clock),
// ~1.86 Tcell/s at 1.98 GHz; the bytes (one read of each input row) take
// ~0.04 ms at the production shape, far below it. The kernel reaches ~84%
// of that bound on an H100 at 700 W (chip_smoke.py phase 2, P = 32768,
// bucket 2048); the rest is each row's fixed work, which the cell count
// above leaves out.
//
// The design. Each problem is a group of G lanes, each lane holding C = 8
// consecutive band cells of H, V, the best cell and the target window in
// registers (B = C*G): G = 16 at band 128 (two problems per warp), G = 32
// at band 256. On the H100 at band 128 this ran 3.44 ms against 4.37-4.43
// ms for C = 4, G = 32 (chip_smoke.py phase 2, which timed both layouts
// until the 4-cell one was removed): the 8-cell layout spreads each row's
// fixed work (the shuffles, the cross-lane scan, the slide of the target
// window) over twice the cells and shortens the scan to 4 steps. Per row
// and cell:
// - The horizontal gap, a log-shift cascade on the TPU, is the exact
//   identity (htmp >= 0) F[k] = ext*k + max_{j<k} (htmp[j] + oe - ext*(j+1)),
//   a lane-local scan plus a log2(G)-step __shfl_up_sync prefix max over
//   the group. The scan runs in the lane's own frame (offsets relative to
//   its first cell), so every per-cell constant is uniform across lanes
//   and no register holds one.
// - Hopper's DPX instructions fuse add+max and add+max+relu (VIADDMNMX).
// - Each cell's best score and the first row reaching it are one key,
//   H * 2^15 + (2^15 - 1 - row), kept by a plain max: a higher score wins,
//   and at an equal score the earlier row's larger key stays, which is the
//   strict > rule. It needs row < 2^15 (the wrapper checks bucket) and
//   score < 2^16. On the H100 it ran faster than __vibmax_s32 plus a select
//   of the row, and holds one register per cell fewer: that build spilled
//   at 80 registers, this one does not.
// - The substitution is one prmt: each target code is kept as a byte
//   selector with sign replication, and each read row as a word of four
//   int8 scores (match at the row's code, mismatch elsewhere).
// - Where match * bucket >= 2^16 or match or mismatch is outside int8, the
//   launcher takes the wide build instead (kWide): codes compared and a
//   select for the substitution, the best score by __vibmax_s32 (its
//   predicate a >= b keeps the earlier row on a tie) and its row in a
//   register of its own. Same contract, no range limit beyond int32.
// - No row waits on device memory: at the start of every G rows each lane
//   of the group loads one read byte and one incoming target byte of the
//   next G rows; rows take them by shuffle.
// - The target window is a ring of C registers indexed by row mod C (the
//   row loop is unrolled C times), so sliding it costs one shuffle and no
//   register moves.
// ptxas (-Xptxas -v, sm_90a): 80 registers for the narrow build (both
// bands), no spills, no stack; the wide build 80 registers with 24-32
// bytes of stack and spill. chip_smoke.py prints every build's line.
//
// The reverse pass (K1', replacing the same Pallas kernel as called by
// svjedi_tpu/kernels/band_dp_v3.py:band_dp_v3_rev, which flips the
// windows first) is the kRev build of the same body, entry
// band_dp_v3_rev_launch. It reads each problem's end-clamped windows
// backwards from its last valid row (m' = qe + 1 of the forward pass), with
// no copy, and runs only the warp's largest m' rows, where the flipped
// windows needed all bucket rows. Where the mismatch, open + extend or
// extend is positive, a sentinel row can change H, so the wrapper
// (kernels/band_dp_v3.py:band_dp_v3_rev) passes m' = bucket for every
// problem: every row runs, and the addresses below are exactly those of the
// flipped windows. Its bound is the forward pass's: 9 ops
// per cell over sum(m') rows. On an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 2, P = 32768, bucket 2048, m' = qe + 1) it took 3.656 ms against
// that 2.887 ms bound (79.0%), where flipping and rolling the windows and
// running the forward build on all rows took 6.241 ms. ptxas: 63-80
// registers for the reverse builds, no spill.

#include "band_dp_common.cuh"

namespace {

using namespace svjt;

// kRev: the reverse pass (K1'). Problem p's valid rows are [0, m'), m' =
// min(m[p], bucket); reversed row r is read row m' - 1 - r and reversed
// cell k pairs it with target row m' - 1 - r + B - 1 - k. That is the
// forward pass on the flipped windows (qT flipped, tT flipped and shifted
// by one row) without the sentinel prefix the flip puts first: those rows
// leave every cell at H = 0 and V <= oe, the state this loop starts from
// (V is recomputed before it is read). Rows r >= m' read sentinel 4.
template <int C, int G, bool kWide, bool kRev>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_v3_kernel(const int8_t* __restrict__ qT, const int8_t* __restrict__ tT,
                  const int32_t* __restrict__ prefetch,
                  const int32_t* __restrict__ mvec, int32_t* __restrict__ out,
                  int P, int bucket, int match, int mismatch, int oe,
                  int ext) {
  constexpr int B = C * G;
  constexpr int kGroups = 32 / G;  // problems per warp
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the problem's group
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int p = warp * kGroups + lane / G;
  const int n_valid = prefetch[0];
  // A problem scoring 0 or at index >= n_valid: the forward pass's
  // (0, -1, -1); the reverse pass's (0, bucket, bucket + B - 1), which is
  // what the flipped forward pass maps -1 to.
  const int none_q = kRev ? bucket : -1;
  const int none_t = kRev ? bucket + B - 1 : -1;
  if (warp * kGroups >= n_valid) {  // the whole warp is padding
    if (gl == 0) {
      out[3 * p] = 0;
      out[3 * p + 1] = none_q;
      out[3 * p + 2] = none_t;
    }
    return;
  }
  const int mrow = kRev ? max(0, min(mvec[p], bucket)) : 0;
  int rows;
  if constexpr (kRev) {
    // The warp runs its longest problem's rows, rounded up to 8 (<= bucket).
    rows = ((__reduce_max_sync(kFull, mrow) + 7) >> 3) << 3;
  } else {
    // The problems of a warp share one 128-problem group, hence one bound.
    const int bound = prefetch[1 + (p >> 7)];
    rows = max(0, min(((bound + 7) >> 3) << 3, bucket));
  }
  const size_t stride = (size_t)P;
  const int8_t* q = qT + p;
  const int8_t* t = tT + p;
  // Read code of row r and target code at x = row + cell, in the order the
  // rows and cells are visited (forward, or the flipped order of kRev).
  auto q_at = [&](int r) -> int {
    if constexpr (kRev) return r < mrow ? q[(size_t)(mrow - 1 - r) * stride] : 4;
    else return r < rows ? q[(size_t)r * stride] : 4;
  };
  auto t_at = [&](int x) -> int {
    if constexpr (kRev) {
      const int j = mrow + B - 2 - x;
      return j >= 0 ? t[(size_t)j * stride] : 4;
    } else {
      return x < rows + B ? t[(size_t)x * stride] : 4;
    }
  };
  const int k0 = gl * C;
  const int lane_off = -ext * k0;  // F source bias of cell k0 - that of cell 0
  const uint32_t mm4 = (uint32_t)(mismatch & 0xff) * 0x01010101u;
  const uint32_t flip = (uint32_t)((match ^ mismatch) & 0xff);

  // KEY: the narrow build's packed (score, row) key, the wide build's best
  // score, whose row BROW holds.
  int H[C], V[C], KEY[C], BROW[kWide ? C : 1], T[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;
    V[c] = kNeg;
    KEY[c] = kWide ? 0 : kRowMask;  // score 0: never the reported best
    if constexpr (kWide) BROW[c] = -1;
    T[c] = target_word<kWide>(t_at(k0 + c));
  }
  // Read scores of rows [chunk, chunk + G) and target codes entering the
  // band at those rows (row + B), one of each per lane of the group.
  uint32_t qw = row_word<kWide>(q_at(gl), mm4, flip);
  int tw = target_word<kWide>(t_at(B + gl));

  for (int chunk = 0; chunk < rows; chunk += G) {
    const int nr = chunk + G + gl;
    const int q_next = q_at(nr);
    const int t_next = t_at(nr + B);
#pragma unroll 1
    for (int sub = 0; sub < G && chunk + sub < rows; sub += C) {
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int i = chunk + sub + r;
        const uint32_t row = __shfl_sync(kFull, qw, sub + r, G);
        const int t_in = __shfl_sync(kFull, tw, sub + r, G);
        int h_next = __shfl_down_sync(kFull, H[0], 1, G);
        int v_next = __shfl_down_sync(kFull, V[0], 1, G);
        if (gl == G - 1) {
          h_next = kNeg;
          v_next = kNeg;
        }
        int htmp[C], hn[C], vnew[C];
        int run = kNeg;  // lane-local F sources so far, in the lane's frame
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int h_up = (c + 1 < C) ? H[c + 1] : h_next;
          const int v_up = (c + 1 < C) ? V[c + 1] : v_next;
          vnew[c] = __viaddmax_s32(v_up, ext, h_up + oe);
          const int s =
              score<kWide>(row, T[(c + r) % C], mm4, match, mismatch);
          htmp[c] = __viaddmax_s32_relu(H[c], s, vnew[c]);
          hn[c] = c == 0 ? htmp[0] : __viaddmax_s32(run, ext * c, htmp[c]);
          run = __viaddmax_s32(htmp[c], oe - ext * (c + 1), run);
        }
        // Prefix max of the lane totals over the group, then exclusive.
        int incl = run + lane_off;
#pragma unroll
        for (int off = 1; off < G; off <<= 1) {
          const int o = __shfl_up_sync(kFull, incl, off, G);
          if (gl >= off) incl = max(incl, o);
        }
        int excl = __shfl_up_sync(kFull, incl, 1, G);
        excl = gl == 0 ? kNeg : excl - lane_off;
        const int row_key = kRowMask - i;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int h = __viaddmax_s32(excl, ext * c, hn[c]);
          if constexpr (kWide) {
            bool keep;  // KEY >= h: an equal score keeps the earlier row
            KEY[c] = __vibmax_s32(KEY[c], h, &keep);
            BROW[c] = keep ? BROW[c] : i;
          } else {
            KEY[c] = max(KEY[c], h * (kRowMask + 1) + row_key);
          }
          H[c] = h;
          V[c] = vnew[c];
        }
        // Slide the window: the slot of cell 0 takes t[i + k0 + C], the
        // next lane's cell 0 (the last lane's comes from t_in).
        const int from_next = __shfl_down_sync(kFull, T[r], 1, G);
        T[r] = gl == G - 1 ? t_in : from_next;
      }
    }
    qw = row_word<kWide>(q_next, mm4, flip);
    tw = target_word<kWide>(t_next);
  }

  int BEST[C], BQE[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if constexpr (kWide) {
      BEST[c] = KEY[c];
      BQE[c] = BROW[c];
    } else {
      BEST[c] = KEY[c] >> 15;
      BQE[c] = BEST[c] > 0 ? kRowMask - (KEY[c] & kRowMask) : -1;
    }
  }
  int best = BEST[0];
#pragma unroll
  for (int c = 1; c < C; ++c) best = max(best, BEST[c]);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, off, G));
  int kmin = 1 << 30;
  int qsel = -1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (BEST[c] == best && k0 + c < kmin) {
      kmin = k0 + c;
      qsel = BQE[c];
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(kFull, kmin, off, G);
    const int oq = __shfl_xor_sync(kFull, qsel, off, G);
    if (ok < kmin) {
      kmin = ok;
      qsel = oq;
    }
  }
  if (gl == 0) {
    const bool scored = p < n_valid && best > 0;
    // kRev: back to original coordinates, qs = m' - 1 - r*, ts = qs + B - 1 - k*.
    const int qo = kRev ? mrow - 1 - qsel : qsel;
    out[3 * p] = p < n_valid ? best : 0;
    out[3 * p + 1] = scored ? qo : none_q;
    out[3 * p + 2] = scored ? (kRev ? qo + B - 1 - kmin : qo + kmin) : none_t;
  }
}

template <int G, bool kWide, bool kRev>
int launch(const int8_t* q, const int8_t* t, const int32_t* pf,
           const int32_t* m, int32_t* o, int P, int bucket, int match,
           int mismatch, int oe, int ext, cudaStream_t s) {
  constexpr int kPerBlock = kWarpsPerBlock * (32 / G);
  if (P % kPerBlock != 0) return static_cast<int>(cudaErrorInvalidValue);
  band_dp_v3_kernel<8, G, kWide, kRev>
      <<<P / kPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
          q, t, pf, m, o, P, bucket, match, mismatch, oe, ext);
  return static_cast<int>(cudaGetLastError());
}

// Picks the build (needs_wide) and the band's group width.
template <bool kRev>
int launch_any(const void* qT, const void* tT, const void* prefetch,
               const void* m, void* out, int P, int bucket, int band,
               int match, int mismatch, int oe, int ext, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(qT);
  const int8_t* t = static_cast<const int8_t*>(tT);
  const int32_t* pf = static_cast<const int32_t*>(prefetch);
  const int32_t* mv = static_cast<const int32_t*>(m);
  int32_t* o = static_cast<int32_t*>(out);
  const bool wide = needs_wide(match, mismatch, oe, ext, bucket, band);
#define SVJT_LAUNCH(G, W) \
  launch<G, W, kRev>(q, t, pf, mv, o, P, bucket, match, mismatch, oe, ext, s)
  if (band == 128) return wide ? SVJT_LAUNCH(16, true) : SVJT_LAUNCH(16, false);
  if (band == 256) return wide ? SVJT_LAUNCH(32, true) : SVJT_LAUNCH(32, false);
#undef SVJT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Forward pass: prefetch = [n_valid] ++ one row bound per 128 problems.
extern "C" int band_dp_v3_fwd_launch(const void* qT, const void* tT,
                                     const void* prefetch, void* out, int P,
                                     int bucket, int band, int match,
                                     int mismatch, int oe, int ext,
                                     void* stream) {
  return launch_any<false>(qT, tT, prefetch, nullptr, out, P, bucket, band,
                           match, mismatch, oe, ext, stream);
}

// Reverse pass (K1'): prefetch[0] = n_valid (row bounds are not read), m =
// (P,) int32 valid rows per problem (qe + 1 of the forward pass).
extern "C" int band_dp_v3_rev_launch(const void* qT, const void* tT,
                                     const void* prefetch, const void* m,
                                     void* out, int P, int bucket, int band,
                                     int match, int mismatch, int oe, int ext,
                                     void* stream) {
  if (m == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any<true>(qT, tT, prefetch, m, out, P, bucket, band, match,
                          mismatch, oe, ext, stream);
}

extern "C" const char* svjt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
