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
// end is band_dp_batch's row rule, not K1/K3/K4's per-cell rule: the first
// row whose maximum strictly beats
// the best so far, and in that row the lowest band offset. Output per
// problem: 8 int32 [score, matches, n_diag, qe, te, 0, 0, 0]; a problem
// scoring 0 writes [0, 0, 0, -1, -1, 0, 0, 0].
//
// Two entries, both on dp_body (band_dp_body.cuh) with kStats (the rider)
// and kRowEnd (the row rule) set. band_dp_stats_kernel takes K4's entry
// (gathered_entry: pre-gathered windows, the row scan that finds each
// problem's last non-sentinel row). band_dp_stats_kernel_flat takes K3's
// (flat_entry): it fetches each piece's windows itself from the chunk's
// resident buffers, reads2 (forward codes ++ reverse complement) and
// panel_padded, by per-piece int32 offsets (q_start, t_start, m, t_lo,
// t_hi), so the audit assembles and copies no window on the host. Bands
// 128 and 256 take K4's layouts (16 and 32 lanes x 8 cells); band 512, the
// audit's band when cfg.band is 256, takes 32 lanes x 16 cells, so rows
// run in multiples of 16 there. Rows: where rows_skip_exact holds, a warp
// runs up to its problems' last non-sentinel row (the flat entry: their
// largest min(m, bucket), as K3), rounded up to the cells per lane; a
// sentinel row then cannot strictly beat the best. Otherwise every row
// runs. The rider needs M (the flat entry: bucket) < 2^16 (the wrapper
// refuses more);
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
  gathered_entry<G, C, kWide, true, true>(q, t, out, P, M, skip, match,
                                          mismatch, oe, ext);
}

template <int G, int C, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_stats_kernel_flat(const int8_t* __restrict__ reads, long long n_reads,
                          const int8_t* __restrict__ panel, long long n_panel,
                          const int32_t* __restrict__ q_start,
                          const int32_t* __restrict__ t_start,
                          const int32_t* __restrict__ m,
                          const int32_t* __restrict__ t_lo,
                          const int32_t* __restrict__ t_hi,
                          int32_t* __restrict__ out, int P, int bucket,
                          bool skip, int match, int mismatch, int oe,
                          int ext) {
  flat_entry<G, C, kWide, true, true>(reads, n_reads, panel, n_panel, q_start,
                                      t_start, m, t_lo, t_hi, out, P, bucket,
                                      skip, match, mismatch, oe, ext);
}

// The narrow build's packed (score, row) key holds rows below 2^15.
bool stats_wide(int match, int mismatch, int oe, int ext, int rows,
                int band) {
  return wide_build(match, mismatch, oe, ext, rows, band) || rows >= (1 << 15);
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
  const bool wide = stats_wide(match, mismatch, oe, ext, M, band);
  return for_banded_build(band, M, wide, [&](auto g, auto c, auto w) {
    constexpr int G = decltype(g)::value;
    band_dp_stats_kernel<G, decltype(c)::value, decltype(w)::value>
        <<<grid_for<G>(P), 32 * kWarpsPerBlock, 0, s>>>(
            qq, tt, o, P, M, skip, match, mismatch, oe, ext);
  });
}

// The fused fetch: reads (n_reads bytes) and panel (n_panel bytes) int8;
// q_start, t_start, m, t_lo, t_hi: int32 (P,) each; out: int32 (P, 8).
// Problem p runs `bucket` rows on reads[q_start + i] (4 at i >= m) against
// panel[t_start + j] (4 outside [t_lo, t_hi)). band 128, 256 or 512;
// bucket a multiple of 8 (of 16 at band 512) and below 2^16.
extern "C" int band_dp_stats_flat_launch(
    const void* reads, long long n_reads, const void* panel,
    long long n_panel, const void* q_start, const void* t_start,
    const void* m, const void* t_lo, const void* t_hi, void* out, int P,
    int bucket, int band, int match, int mismatch, int oe, int ext,
    void* stream) {
  if (P <= 0) return 0;
  if (bucket <= 0 || bucket >= (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* rd = static_cast<const int8_t*>(reads);
  const int8_t* pn = static_cast<const int8_t*>(panel);
  const int32_t* qs = static_cast<const int32_t*>(q_start);
  const int32_t* ts = static_cast<const int32_t*>(t_start);
  const int32_t* mm = static_cast<const int32_t*>(m);
  const int32_t* lo = static_cast<const int32_t*>(t_lo);
  const int32_t* hi = static_cast<const int32_t*>(t_hi);
  int32_t* o = static_cast<int32_t*>(out);
  const bool skip = rows_skip_exact(mismatch, oe, ext);
  const bool wide = stats_wide(match, mismatch, oe, ext, bucket, band);
  return for_banded_build(band, bucket, wide, [&](auto g, auto c, auto w) {
    constexpr int G = decltype(g)::value;
    band_dp_stats_kernel_flat<G, decltype(c)::value, decltype(w)::value>
        <<<grid_for<G>(P), 32 * kWarpsPerBlock, 0, s>>>(
            rd, n_reads, pn, n_panel, qs, ts, mm, lo, hi, o, P, bucket, skip,
            match, mismatch, oe, ext);
  });
}
