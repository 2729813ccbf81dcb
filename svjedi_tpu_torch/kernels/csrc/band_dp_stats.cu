// The audit re-score's stats DP (A1): banded affine-gap local alignment
// that carries, along the optimal path, the exact matches and the diagonal
// steps.
//
// Replaces svjedi_tpu/align/extend.py:band_dp_stats_batch, a jitted
// lax.scan (XLA, not Pallas) that compute_winner_stats runs on every piece
// of every winning span. Contract: pre-gathered q (P, M) and t (P, M + B),
// int8, sentinel 4 matching nothing; cell (i, k) pairs read row i with
// target position i + k. The value recurrence and its tie rules are K3/K4's
// (band_dp_onepass.cu): a gap opening beats extending a vertical gap (>=),
// the diagonal beats a vertical gap (>=), a cell at <= 0 resets to 0, a
// horizontal gap must be strictly better, and among tied horizontal sources
// the nearest wins. What rides along is (n_diag << 16 | matches): 0 at the
// start and at a reset, plus (1 << 16) + is_match on a diagonal step. The
// end is K1's rule, not K3/K4's: the first row whose maximum strictly beats
// the best so far, and in that row the lowest band offset. Output per
// problem: 8 int32 [score, matches, n_diag, qe, te, 0, 0, 0]; a problem
// scoring 0 writes [0, 0, 0, -1, -1, 0, 0, 0].
//
// The design: K4's entry (pre-gathered windows, the row scan that finds
// each problem's last non-sentinel row) on dp_body (band_dp_body.cuh) with
// kStats set, which changes the rider and the final reduction only. Bands
// 128 and 256 take K4's layouts (16 and 32 lanes x 8 cells); band 512, the
// audit's band when cfg.band is 256, takes 32 lanes x 16 cells, so rows
// run in multiples of 16 there. Rows: where rows_skip_exact holds, a warp
// runs up to its problems' last non-sentinel row, rounded up to the cells
// per lane; a sentinel row then cannot strictly beat the best. Otherwise
// every row runs. The rider needs M < 2^16 (the wrapper refuses more);
// scores take the wide build where needs_wide says so, and so do rows
// past the narrow key's 2^15.
//
// What bounds it on the H100: integer issue, as K3/K4. A row costs each
// problem one byte of read and one of target; a band cell costs K3/K4's 14
// int32 operations as the bound counts them plus one add for the diagonal
// step's increment, 15 (the narrow build also issues a second prmt for the
// match bit). Times, bound and share: PERF.md section 6 (chip_smoke.py
// phase 2e).

#include "band_dp_body.cuh"

namespace {

template <int G, int C, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_stats_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ t, int32_t* __restrict__ out,
                     int P, int M, bool skip, int match, int mismatch, int oe,
                     int ext) {
  constexpr int B = C * G;
  constexpr int kGroups = 32 / G;  // problems per warp
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the problem's group
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp * kGroups >= P) return;
  const int p = warp * kGroups + lane / G;
  const bool live = p < P;  // a dead group still takes part in shuffles
  const int8_t* qp = q + (size_t)p * M;
  const bool vec = M % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int own_rows = skip ? coded_rows<G>(qp, M, vec, live, gl) : M;
  const Gathered src{qp, t + (size_t)p * (M + B), live ? own_rows : 0,
                     live && own_rows > 0 ? own_rows + B : 0};
  dp_body<G, C, kWide, true>(src, warp_rows<C>(own_rows, M, skip), gl, live,
                             match, mismatch, oe, ext, out + 8 * (size_t)p);
}

template <int G, int C, bool kWide>
int launch(const int8_t* q, const int8_t* t, int32_t* out, int P, int M,
           bool skip, int match, int mismatch, int oe, int ext,
           cudaStream_t s) {
  if (M % C != 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kPerBlock = kWarpsPerBlock * (32 / G);
  band_dp_stats_kernel<G, C, kWide>
      <<<(P + kPerBlock - 1) / kPerBlock, 32 * kWarpsPerBlock, 0, s>>>(
          q, t, out, P, M, skip, match, mismatch, oe, ext);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWide>
int launch_band(int band, const int8_t* q, const int8_t* t, int32_t* out,
                int P, int M, bool skip, int match, int mismatch, int oe,
                int ext, cudaStream_t s) {
  switch (band) {
    case 128:
      return launch<16, kCells, kWide>(q, t, out, P, M, skip, match, mismatch,
                                       oe, ext, s);
    case 256:
      return launch<32, kCells, kWide>(q, t, out, P, M, skip, match, mismatch,
                                       oe, ext, s);
    case 512:
      return launch<32, 2 * kCells, kWide>(q, t, out, P, M, skip, match,
                                           mismatch, oe, ext, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: int8 (P, M), t: int8 (P, M + band), out: int32 (P, 8). band 128, 256
// or 512; M a multiple of 8 (of 16 at band 512) and below 2^16.
extern "C" int band_dp_stats_launch(const void* q, const void* t, void* out,
                                    int P, int M, int band, int match,
                                    int mismatch, int oe, int ext,
                                    void* stream) {
  if (P <= 0) return 0;
  if (M <= 0 || M >= (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const int8_t* tt = static_cast<const int8_t*>(t);
  int32_t* o = static_cast<int32_t*>(out);
  const bool skip = rows_skip_exact(mismatch, oe, ext);
  // The narrow build's packed (score, row) key holds rows below 2^15.
  return wide_build(match, mismatch, oe, ext, M, band) || M >= (1 << 15)
             ? launch_band<true>(band, qq, tt, o, P, M, skip, match, mismatch,
                                 oe, ext, s)
             : launch_band<false>(band, qq, tt, o, P, M, skip, match,
                                  mismatch, oe, ext, s);
}
