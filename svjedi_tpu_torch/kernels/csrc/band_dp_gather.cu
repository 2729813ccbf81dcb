// The gather engine's one-pass DP (G1): banded affine-gap local alignment
// with score, start and end, and band_dp_batch's row rule for the end.
//
// Replaces svjedi_tpu/align/extend.py:band_dp_batch, a jitted lax.scan
// (XLA, not Pallas): the DP of engine="gather" (window_score) and of the
// count step's "xla" engine, the one-device truth of the sharded step's dry
// run. Contract: pre-gathered q (P, M) and t (P, M + B), int8, sentinel 4
// matching nothing; cell (i, k) pairs read row i with target position
// i + k. Values, starts and their tie rules are K3/K4's
// (band_dp_onepass.cu): a gap opening beats extending a vertical gap (>=),
// the diagonal beats a vertical gap (>=), a cell at <= 0 resets to 0 with
// start (i + 1, i + 1 + k), a horizontal gap must be strictly better, and
// among tied horizontal sources the nearest wins. The end is the row rule,
// not K1/K3/K4's per-cell rule: the first row whose maximum strictly beats
// the best so far, and in that row the lowest band offset. Output per problem: 8 int32 [score,
// qs, ts, qe, te, 0, 0, 0]; a problem scoring 0 writes
// [0, 0, 0, -1, -1, 0, 0, 0].
//
// The design: K4's entry (gathered_entry in band_dp_body.cuh) on dp_body
// with the start rider (kStats false) and the row rule (kRowEnd true), which
// changes only the final reduction against K4. Bands 128 and 256 take K4's
// layouts (16 and 32 lanes x 8 cells), band 512 A1's (32 lanes x 16
// cells). Rows: where rows_skip_exact holds, a warp runs up to its
// problems' last non-sentinel row, rounded up to the cells per lane, since
// a sentinel row then cannot strictly beat the best; otherwise every row
// runs. The packed start needs M < 2^15 and M + B < 2^16 (the launcher and
// the wrapper refuse more); scores take the wide build where wide_build
// says so.
//
// What bounds it on the H100: integer issue, as K3/K4: a row costs each
// problem one byte of read and one of target, a band cell the 14 int32
// operations of K3/K4. Times, bound and share: PERF.md section 6
// (chip_smoke.py phase 2f).

#include "band_dp_body.cuh"

namespace {

template <int G, int C, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_gather_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ t, int32_t* __restrict__ out,
                      int P, int M, bool skip, int match, int mismatch,
                      int oe, int ext) {
  gathered_entry<G, C, kWide, false, true>(q, t, out, P, M, skip, match,
                                           mismatch, oe, ext);
}

}  // namespace

// q: int8 (P, M), t: int8 (P, M + band), out: int32 (P, 8). band 128, 256
// or 512; M a multiple of 8 (of 16 at band 512), M < 2^15 and
// M + band < 2^16.
extern "C" int band_dp_gather_launch(const void* q, const void* t, void* out,
                                     int P, int M, int band, int match,
                                     int mismatch, int oe, int ext,
                                     void* stream) {
  if (P <= 0) return 0;
  if (M <= 0 || M >= (1 << 15) || M + band >= (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const int8_t* tt = static_cast<const int8_t*>(t);
  int32_t* o = static_cast<int32_t*>(out);
  const bool skip = rows_skip_exact(mismatch, oe, ext);
  const bool wide = wide_build(match, mismatch, oe, ext, M, band);
  return for_banded_build(band, M, wide, [&](auto g, auto c, auto w) {
    constexpr int G = decltype(g)::value;
    band_dp_gather_kernel<G, decltype(c)::value, decltype(w)::value>
        <<<grid_for<G>(P), 32 * kWarpsPerBlock, 0, s>>>(
            qq, tt, o, P, M, skip, match, mismatch, oe, ext);
  });
}
