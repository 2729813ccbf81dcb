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

#include <type_traits>

#include "band_dp_common.cuh"

namespace {

using namespace svjt;

// Windows of the pre-gathered entry: one problem's rows of q and t.
struct Gathered {
  const int8_t* q;  // M bytes
  const int8_t* t;  // M + band bytes
  int rows;         // last non-sentinel read row + 1: q reads 4 beyond it
  int t_len;        // rows + band (0 without rows): no row reads t beyond it
  __device__ int q_at(int i) const { return i < rows ? q[i] : 4; }
  __device__ int t_at(int j) const { return j < t_len ? t[j] : 4; }
};

// Windows of the fused-fetch entry: offsets into the flat buffers.
struct Flat {
  const int8_t* reads;
  long long n_reads;
  long long q0;  // q_start
  int rows;      // min(m, bucket): read rows beyond read as 4
  const int8_t* panel;
  long long t0;  // t_start
  long long lo;  // max(t_lo, 0)
  long long hi;  // min(t_hi, panel length)
  __device__ int q_at(int i) const {
    const long long pos = q0 + i;
    return (i < rows && pos >= 0 && pos < n_reads) ? reads[pos] : 4;
  }
  __device__ int t_at(int j) const {
    const long long pos = t0 + j;
    return (pos >= lo && pos < hi) ? panel[pos] : 4;
  }
};

constexpr int C = 8;  // cells per lane

// The rows a warp runs: its problems' largest own row count, rounded up to
// C, where trailing sentinel rows may be skipped, else every row.
__device__ __forceinline__ int warp_rows(int own_rows, int all_rows,
                                         bool skip) {
  const int rows = skip ? __reduce_max_sync(kFull, own_rows) : all_rows;
  return (rows + C - 1) / C * C;
}

// The body both entries share: G lanes x C cells per problem, K1's layout,
// with each cell's packed start carried beside its value. The warp runs
// `rows` rows (a multiple of C). The narrow build (kWide false) takes the one-prmt
// substitution, a packed (score, row) best key and a packed (value, lane)
// key for the cross-lane scan; the wide build compares codes, keeps the
// best row in a register and scans (value, lane) pairs. Every lane of the
// warp calls it (a dead group still takes part in shuffles); a live group's
// lane 0 writes the problem's 8 outputs to o.
template <int G, bool kWide, class Src>
__device__ __forceinline__ void dp_body(const Src& src, int rows, int gl,
                                        bool live, int match, int mismatch,
                                        int oe, int ext,
                                        int32_t* __restrict__ o) {
  constexpr int B = C * G;
  const int k0 = gl * C;
  const uint32_t mm4 = (uint32_t)(mismatch & 0xff) * 0x01010101u;
  const uint32_t flip = (uint32_t)((match ^ mismatch) & 0xff);

  // H, V and their packed starts SH, SV; KEY: the narrow build's packed
  // (score, row) best key, the wide build's best score (row in BROW); BS:
  // the best's start; T: the target window, a ring indexed by row mod C.
  int H[C], V[C], SH[C], SV[C], KEY[C], BS[C], BROW[kWide ? C : 1], T[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;
    V[c] = kNeg;
    SH[c] = k0 + c;  // packed (0 << 16) | k
    SV[c] = k0 + c;
    KEY[c] = kWide ? 0 : kRowMask;  // score 0: never the reported best
    BS[c] = 0;
    if constexpr (kWide) BROW[c] = -1;
    T[c] = target_word<kWide>(src.t_at(k0 + c));
  }
  // Read words of rows [chunk, chunk + G) and target codes entering the
  // band at those rows (row + B), one of each per lane, a chunk ahead.
  uint32_t qw = row_word<kWide>(src.q_at(gl), mm4, flip);
  int tw = target_word<kWide>(src.t_at(B + gl));

  for (int chunk = 0; chunk < rows; chunk += G) {
    const int nr = chunk + G + gl;
    const int q_next = src.q_at(nr);
    const int t_next = src.t_at(nr + B);
#pragma unroll 1
    for (int sub = 0; sub < G && chunk + sub < rows; sub += C) {
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int i = chunk + sub + r;
        const uint32_t row = __shfl_sync(kFull, qw, sub + r, G);
        const int t_in = __shfl_sync(kFull, tw, sub + r, G);
        // Vertical parent of the lane's last cell: the next lane's cell 0,
        // whose (value, start) that lane makes. Each choice below that a
        // start follows is a DPX add-max for the value and an equality
        // test for the predicate: max(a + b, c) == c exactly when c >= a + b.
        const int open0 = H[0] + oe;
        const int up0 = __viaddmax_s32(V[0], ext, open0);  // open wins a tie
        int v_last = __shfl_down_sync(kFull, up0, 1, G);
        int s_last =
            __shfl_down_sync(kFull, up0 == open0 ? SH[0] : SV[0], 1, G);
        if (gl == G - 1) {
          v_last = kNeg;
          s_last = 0;
        }
        const int reset0 = (i + 1) * 0x10001 + k0;  // ((i+1) << 16) + i+1 + k0
        // Cell by cell: V, the diagonal (which wins a tie with V), the reset
        // at <= 0 (into H, SH), and the horizontal gap from the lane's own
        // cells (xv, xs): F[c + 1] = max(F[c] + ext, H[c] + oe), the open
        // (nearer) source winning a tie.
        int xv[C + 1], xs[C + 1];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c + 1 < C) {
            const int open = H[c + 1] + oe;
            V[c] = __viaddmax_s32(V[c + 1], ext, open);
            SV[c] = V[c] == open ? SH[c + 1] : SV[c + 1];
          } else {
            V[c] = v_last;
            SV[c] = s_last;
          }
          const int diag =
              H[c] + score<kWide>(row, T[(c + r) % C], mm4, match, mismatch);
          const int s1 = diag >= V[c] ? SH[c] : SV[c];
          H[c] = __vimax_s32_relu(diag, V[c]);
          SH[c] = H[c] > 0 ? s1 : reset0 + c;
          const int open = H[c] + oe;
          if (c == 0) {
            xv[1] = open;
          } else {
            xv[c + 1] = __viaddmax_s32(xv[c], ext, open);
          }
          xs[c + 1] = c == 0 || xv[c + 1] == open ? SH[c] : xs[c];
        }
        // Exclusive prefix over the group's lanes of the gap each lane
        // hands on (xv[C], at its cell k0 + C), in the frame of cell 0: the
        // best source of an earlier lane and its start (a farther lane must
        // be strictly better), back in this lane's frame; none for lane 0.
        const int out_v = xv[C] - ext * (k0 + C);
        int ev, es;
        if constexpr (!kWide) {
          // (value, lane) packed so that a plain max prefers the nearer
          // (higher) lane at an equal value; values stay far inside
          // int32 / G, since the narrow build has scores < 2^16 and int8
          // gap scores.
          int key = out_v * G + gl;
#pragma unroll
          for (int off = 1; off < G; off <<= 1)
            key = max(key, __shfl_up_sync(kFull, key, off, G));
          const int excl = __shfl_up_sync(kFull, key, 1, G);
          es = __shfl_sync(kFull, xs[C], excl & (G - 1), G);
          ev = gl == 0 ? kNeg : (excl >> (G == 16 ? 4 : 5)) + ext * k0;
        } else {
          int v = out_v, from = gl;
#pragma unroll
          for (int off = 1; off < G; off <<= 1) {
            const int ov = __shfl_up_sync(kFull, v, off, G);
            const int of = __shfl_up_sync(kFull, from, off, G);
            if (ov > v) {
              v = ov;
              from = of;
            }
          }
          const int ev_g = __shfl_up_sync(kFull, v, 1, G);
          es = __shfl_sync(kFull, xs[C], __shfl_up_sync(kFull, from, 1, G), G);
          ev = gl == 0 ? kNeg : ev_g + ext * k0;
        }
        const int row_key = kRowMask - i;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // H = max(H, own gap, earlier lanes' gap): a gap must be strictly
          // better than H, and the lane's own sources, being nearer, win a
          // tie with the earlier lanes'.
          if (c > 0) {
            const bool keep = H[c] >= xv[c];
            H[c] = keep ? H[c] : xv[c];
            SH[c] = keep ? SH[c] : xs[c];
          }
          const int h_own = H[c];
          H[c] = __viaddmax_s32(ev, ext * c, h_own);
          SH[c] = H[c] == h_own ? SH[c] : es;
          // The cell's best: a tie keeps the earlier row.
          bool p_old;
          if constexpr (kWide) {
            KEY[c] = __vibmax_s32(KEY[c], H[c], &p_old);
            BROW[c] = p_old ? BROW[c] : i;
          } else {
            KEY[c] = __vibmax_s32(KEY[c], H[c] * (kRowMask + 1) + row_key,
                                  &p_old);
          }
          BS[c] = p_old ? BS[c] : SH[c];
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
  int kmin = 1 << 30, qsel = -1, bs = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (BEST[c] == best && k0 + c < kmin) {
      kmin = k0 + c;
      qsel = BQE[c];
      bs = BS[c];
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(kFull, kmin, off, G);
    const int oq = __shfl_xor_sync(kFull, qsel, off, G);
    const int os = __shfl_xor_sync(kFull, bs, off, G);
    if (ok < kmin) {
      kmin = ok;
      qsel = oq;
      bs = os;
    }
  }
  if (gl == 0 && live) {
    o[0] = best;
    o[1] = bs >> 16;
    o[2] = bs & 0xFFFF;
    o[3] = qsel;
    o[4] = qsel + kmin;
    o[5] = 0;
    o[6] = 0;
    o[7] = 0;
  }
}

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
  constexpr int kGroups = 32 / G;  // problems per warp
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the problem's group
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp * kGroups >= P) return;
  const int p = warp * kGroups + lane / G;
  const bool live = p < P;  // a dead group still takes part in shuffles
  const int own_rows = live ? max(0, min(m[p], bucket)) : 0;
  const Flat src{reads,
                 n_reads,
                 live ? (long long)q_start[p] : 0LL,
                 own_rows,
                 panel,
                 live ? (long long)t_start[p] : 0LL,
                 live ? max((long long)t_lo[p], 0LL) : 0LL,
                 live ? min((long long)t_hi[p], n_panel) : 0LL};
  dp_body<G, kWide>(src, warp_rows(own_rows, bucket, skip), gl, live, match,
                    mismatch, oe, ext, out + 8 * (size_t)p);
}

// Rows of a pre-gathered read window up to its last code other than 4 (0
// for an all-sentinel or dead row), the same in every lane of the group:
// each lane scans every G-th 16-byte piece (every G-th byte where the rows
// are not 16-byte aligned), then a max over the group.
template <int G>
__device__ __forceinline__ int coded_rows(const int8_t* __restrict__ q,
                                          int M, bool vec, bool live,
                                          int gl) {
  int last = -1;
  if (live && vec) {
    const uint4* w = reinterpret_cast<const uint4*>(q);
    for (int j = gl; j < M / 16; j += G) {
      const uint4 v = w[j];
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Bytes other than 4 are nonzero in d; the highest gives the row.
        const uint32_t d = x[e] ^ 0x04040404u;
        if (d) last = 16 * j + 4 * e + ((31 - __clz(d)) >> 3);
      }
    }
  } else if (live) {
    for (int j = gl; j < M; j += G)
      if (q[j] != 4) last = j;
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, off, G));
  return last + 1;
}

// K4: pre-gathered windows q (P, M) and t (P, M + band).
template <int G, bool kWide>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_onepass_kernel(const int8_t* __restrict__ q,
                       const int8_t* __restrict__ t,
                       int32_t* __restrict__ out, int P, int M, bool skip,
                       int match, int mismatch, int oe, int ext) {
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
  dp_body<G, kWide>(src, warp_rows(own_rows, M, skip), gl, live, match,
                    mismatch, oe, ext, out + 8 * (size_t)p);
}

// Calls launch(G, kWide) with the build for the band and the scores, and
// returns the launch's CUDA error. Every row count must be a multiple of C.
template <class Launch>
int for_build(int band, int rows, bool wide, Launch launch) {
  if (rows % C != 0) return static_cast<int>(cudaErrorInvalidValue);
  using N16 = std::integral_constant<int, 16>;
  using N32 = std::integral_constant<int, 32>;
  using Narrow = std::false_type;
  using Wide = std::true_type;
  if (band == 128) wide ? launch(N16{}, Wide{}) : launch(N16{}, Narrow{});
  else if (band == 256) wide ? launch(N32{}, Wide{}) : launch(N32{}, Narrow{});
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Problems per block of a build, and the blocks for P problems.
template <int G>
dim3 grid_for(int P) {
  constexpr int kPerBlock = kWarpsPerBlock * (32 / G);
  return dim3((P + kPerBlock - 1) / kPerBlock);
}

// The narrow build also packs (value, lane) into one int for its scan,
// which gap scores in int8 keep far inside int32.
bool wide_build(int match, int mismatch, int oe, int ext, int rows,
                int band) {
  return needs_wide(match, mismatch, oe, ext, rows, band) || !fits_int8(oe) ||
         !fits_int8(ext);
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
