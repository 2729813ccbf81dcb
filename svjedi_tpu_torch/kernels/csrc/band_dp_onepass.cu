// One-pass banded affine-gap local alignment: score, start and end.
//
// Replaces two Pallas TPU kernels that share one DP:
//   svjedi_tpu/kernels/band_dp_dma.py:_kernel (band_dp_dma_raw), which
//     fetches each problem's windows itself from the flat read and panel
//     buffers -> entry band_dp_dma_kernel (K3);
//   svjedi_tpu/kernels/band_dp.py:_kernel (band_dp_pallas), which reads
//     pre-gathered (P, M) / (P, M + band) windows -> entry
//     band_dp_onepass_kernel (K4).
// Contract: cell (i, k) pairs read row i with target position i + k; codes
// are int8 with sentinel 4 matching nothing. Every cell carries the packed
// start (qs << 16 | ts) of its optimal path, with the TPU kernels' tie
// rules: a gap opening beats extending a vertical gap (>=), the diagonal
// beats a vertical gap (>=), a cell at <= 0 resets to 0 with start
// ((i+1) << 16) + (i+1) + k, a horizontal gap must be strictly better, and
// among tied horizontal sources the nearest wins. Each band cell keeps the
// first row at which it reaches its best (strict >); the problem's result
// is the lowest band offset among cells tied at the maximum. Output per
// problem: 8 int32 [score, qs, ts, qe, te = qe + k, 0, 0, 0]; a problem
// scoring 0 writes [0, 0, 0, -1, -1, 0, 0, 0].
//
// Both entries run one body, dp_body, on K1's Hopper layout
// (band_dp_v3.cu) with starts; they differ only in where a window's bytes
// come from (Flat: offsets into the flat buffers, masked to m and to
// [t_lo, t_hi); Gathered: the problem's rows of q and t). The layout: G
// lanes x 8 cells per problem (G = 16 at band 128, two problems per warp;
// 32 at band 256), the target window as a register ring indexed by row mod
// 8, the one-prmt substitution, a packed (score, row) best key beside the
// best's start, and read and target bytes loaded a chunk of G rows ahead.
// Values take DPX add-max (VIADDMNMX); where a start follows the choice,
// the predicate is an equality test of the result against one operand and
// the start a select. Inside a lane the horizontal gap is Gotoh's
// F[c + 1] = max(F[c] + ext, H[c] + oe); across lanes, each lane's outgoing
// gap is packed with its lane index into one int, so a plain max prefix
// scan prefers the nearer lane at an equal value, and the winning lane's
// start comes with one shuffle. Scores beyond the narrow build's range
// (needs_wide: a score bound over the rows and band reaching 2^16, or any
// score outside int8)
// take the wide build: codes compared, the best's row in a register, and a
// (value, lane) pair scan.
//
// Rows. The TPU kernels run every row (K3 bucket, K4 M). Where
// rows_skip_exact (band_dp_common.cuh) holds, trailing sentinel rows change
// nothing, and a warp runs only its problems' largest row count, rounded up
// to 8: K3 the largest min(m, bucket), K4 the largest last non-sentinel row
// + 1, which a short prologue finds by scanning each q row (16-byte loads
// where the rows are aligned). Otherwise every warp runs all rows, bucket
// (K3) or M (K4): a multiple of 8 (the launchers refuse others), so
// rounding up adds no row.
//
// What bounds it on the H100: integer issue, not memory. A row costs each
// problem one byte of read and one of target (K4's prologue reads its q
// rows once more); each band cell needs 14 int32 operations as the bound
// counts them (K1's 9 plus five selects that carry the start). Times,
// bounds and shares at P = 32768, bucket 2048: PERF.md section 6
// (chip_smoke.py phase 2b).
// There is no 1024-byte alignment or lane rotate: that was a Mosaic
// constraint on the TPU's DMA, which Hopper does not have.

#include "band_dp_body.cuh"

namespace {

// K3: the fused fetch. Problem p's windows are reads[q_start[p] + i]
// (sentinel at i >= m[p]) and panel[t_start[p] + j] (sentinel outside
// [t_lo[p], t_hi[p]) and outside either buffer).
template <int G, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_dma_kernel(const int8_t* __restrict__ reads, long long n_reads,
                   const int8_t* __restrict__ panel, long long n_panel,
                   const int32_t* __restrict__ q_start,
                   const int32_t* __restrict__ t_start,
                   const int32_t* __restrict__ m,
                   const int32_t* __restrict__ t_lo,
                   const int32_t* __restrict__ t_hi,
                   int32_t* __restrict__ out, int P, int bucket, bool skip,
                   int match, int mismatch, int oe, int ext) {
  flat_entry<G, kCells, kWide, false, false>(
      reads, n_reads, panel, n_panel, q_start, t_start, m, t_lo, t_hi, out, P,
      bucket, skip, match, mismatch, oe, ext);
}

// K4: pre-gathered windows q (P, M) and t (P, M + band).
template <int G, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_onepass_kernel(const int8_t* __restrict__ q,
                       const int8_t* __restrict__ t,
                       int32_t* __restrict__ out, int P, int M, bool skip,
                       int match, int mismatch, int oe, int ext) {
  gathered_entry<G, kCells, kWide, false, false>(q, t, out, P, M, skip, match,
                                                 mismatch, oe, ext);
}

// Calls launch(G, kWide) with the build for the band and the scores, and
// returns the launch's CUDA error. Every row count must be a multiple of
// kCells.
template <class Launch>
int for_build(int band, int rows, bool wide, Launch launch) {
  if (rows % kCells != 0) return static_cast<int>(cudaErrorInvalidValue);
  using N16 = std::integral_constant<int, 16>;
  using N32 = std::integral_constant<int, 32>;
  using Narrow = std::false_type;
  using Wide = std::true_type;
  if (band == 128) wide ? launch(N16{}, Wide{}) : launch(N16{}, Narrow{});
  else if (band == 256) wide ? launch(N32{}, Wide{}) : launch(N32{}, Narrow{});
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int band_dp_onepass_launch(const void* q, const void* t, void* out,
                                      int P, int M, int band, int match,
                                      int mismatch, int oe, int ext,
                                      void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const int8_t* tt = static_cast<const int8_t*>(t);
  int32_t* o = static_cast<int32_t*>(out);
  const bool skip = rows_skip_exact(mismatch, oe, ext);
  return for_build(band, M, wide_build(match, mismatch, oe, ext, M, band),
                   [&](auto g, auto wide) {
    constexpr int G = decltype(g)::value;
    band_dp_onepass_kernel<G, decltype(wide)::value>
        <<<grid_for<G>(P), 32 * kWarpsPerBlock, 0, s>>>(
            qq, tt, o, P, M, skip, match, mismatch, oe, ext);
  });
}

extern "C" int band_dp_dma_launch(const void* reads, long long n_reads,
                                  const void* panel, long long n_panel,
                                  const void* q_start, const void* t_start,
                                  const void* m, const void* t_lo,
                                  const void* t_hi, void* out, int P,
                                  int bucket, int band, int match,
                                  int mismatch, int oe, int ext,
                                  void* stream) {
  if (P <= 0) return 0;
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
  return for_build(band, bucket,
                   wide_build(match, mismatch, oe, ext, bucket, band),
                   [&](auto g, auto wide) {
    constexpr int G = decltype(g)::value;
    band_dp_dma_kernel<G, decltype(wide)::value>
        <<<grid_for<G>(P), 32 * kWarpsPerBlock, 0, s>>>(
            rd, n_reads, pn, n_panel, qs, ts, mm, lo, hi, o, P, bucket, skip,
            match, mismatch, oe, ext);
  });
}
