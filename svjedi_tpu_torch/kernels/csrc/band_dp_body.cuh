// The one-pass DP body (dp_body) and its two entries: pre-gathered windows
// (gathered_entry: K4, band_dp_onepass.cu's band_dp_onepass_kernel; A1,
// the audit's stats DP, band_dp_stats.cu's band_dp_stats_kernel; G1, the
// gather engine's DP, band_dp_gather.cu) and windows fetched from the flat
// read and panel buffers (flat_entry: K3, band_dp_onepass.cu's
// band_dp_dma_kernel; A1's fused fetch, band_dp_stats_kernel_flat). The
// contract, layout and tie rules are band_dp_onepass.cu's head comment;
// the riders and end rules are at dp_body.

#pragma once

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


// Windows of a fused-fetch entry: offsets into the flat buffers.
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


constexpr int kCells = 8;  // cells per lane of K3, K4 and A1 up to band 256

// A1's narrow build: a read code's match word, byte `code` = 1 (none for
// codes >= 4), so prmt with a target selector gives the match bit.
__device__ __forceinline__ uint32_t match_word(int code) {
  return (unsigned)code < 4u ? 1u << (8 * code) : 0u;
}

// What a diagonal step adds to A1's rider (n_diag << 16 | matches).
template <bool kWide>
__device__ __forceinline__ int diag_step(uint32_t row, uint32_t mrow,
                                         int target) {
  if constexpr (kWide) return (1 << 16) + (row < 4u && (int)row == target);
  else return (1 << 16) + substitution(mrow, 0u, (uint32_t)target);
}

// The rows a warp runs: its problems' largest own row count, rounded up to
// C, where trailing sentinel rows may be skipped, else every row.
template <int C>
__device__ __forceinline__ int warp_rows(int own_rows, int all_rows,
                                         bool skip) {
  const int rows = skip ? __reduce_max_sync(kFull, own_rows) : all_rows;
  return (rows + C - 1) / C * C;
}

// The body the one-pass entries share: G lanes x C cells per problem, K1's
// layout, with each cell's packed rider carried beside its value. The warp
// runs `rows` rows (a multiple of C). The narrow build (kWide false) takes
// the one-prmt substitution, a packed (score, row) best key and a packed
// (value, lane) key for the cross-lane scan; the wide build compares codes,
// keeps the best row in a register and scans (value, lane) pairs. Every
// lane of the warp calls it (a dead group still takes part in shuffles); a
// live group's lane 0 writes the problem's 8 outputs to o.
//
// Two compile-time choices, each with its own code path:
// kStats, the rider. False (K3, K4, G1): the packed start (qs << 16 | ts);
// a reset takes ((i + 1) << 16) + i + 1 + k. True (A1): (n_diag << 16 |
// matches), 0 at the start and at a reset; a diagonal step adds (1 << 16)
// + is_match, one three-input add of the match bit, which the narrow build
// takes from a second prmt of a per-row match word (byte `code` = 1).
// kRowEnd, the end. False (K3, K4, as K1 in band_dp_v3.cu): the lowest
// band offset among the cells at the maximum, each cell at the first row of
// its own best. True (A1, G1): band_dp_batch's row rule, the first row
// whose maximum beats the best, then the lowest band offset in that row,
// i.e. the cells ordered by (score, earlier row, lower offset).
// Output [score, qs, ts, qe, te, 0, 0, 0] with the start rider, [score,
// matches, n_diag, qe, te, 0, 0, 0] with the stats rider.
template <int G, int C, bool kWide, bool kStats, bool kRowEnd, class Src>
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
    SH[c] = kStats ? 0 : k0 + c;  // a start: packed (0 << 16) | k
    SV[c] = SH[c];
    KEY[c] = kWide ? 0 : kRowMask;  // score 0: never the reported best
    BS[c] = 0;
    if constexpr (kWide) BROW[c] = -1;
    T[c] = target_word<kWide>(src.t_at(k0 + c));
  }
  // Read words of rows [chunk, chunk + G) and target codes entering the
  // band at those rows (row + B), one of each per lane, a chunk ahead.
  const int q_first = src.q_at(gl);
  uint32_t qw = row_word<kWide>(q_first, mm4, flip);
  uint32_t qm = 0;  // A1's narrow build: the row's match word
  if constexpr (kStats && !kWide) qm = match_word(q_first);
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
        uint32_t mrow = 0;
        if constexpr (kStats && !kWide) mrow = __shfl_sync(kFull, qm, sub + r, G);
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
          const int tc = T[(c + r) % C];
          const int diag = H[c] + score<kWide>(row, tc, mm4, match, mismatch);
          int s_diag = SH[c];
          if constexpr (kStats) s_diag += diag_step<kWide>(row, mrow, tc);
          const int s1 = diag >= V[c] ? s_diag : SV[c];
          H[c] = __vimax_s32_relu(diag, V[c]);
          if constexpr (kStats) SH[c] = H[c] > 0 ? s1 : 0;
          else SH[c] = H[c] > 0 ? s1 : reset0 + c;
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
    if constexpr (kStats && !kWide) qm = match_word(q_next);
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
  int best, qsel, kmin, bs;
  if constexpr (kRowEnd) {
    // The row rule: the highest score, then the earliest row, then the
    // lowest offset (a cell's row is the first of its own best).
    best = BEST[0];
    qsel = BQE[0];
    kmin = k0;
    bs = BS[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      if (BEST[c] > best || (BEST[c] == best && BQE[c] < qsel)) {
        best = BEST[c];
        qsel = BQE[c];
        kmin = k0 + c;
        bs = BS[c];
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(kFull, best, off, G);
      const int oq = __shfl_xor_sync(kFull, qsel, off, G);
      const int ok = __shfl_xor_sync(kFull, kmin, off, G);
      const int os = __shfl_xor_sync(kFull, bs, off, G);
      if (ob > best || (ob == best && (oq < qsel || (oq == qsel && ok < kmin)))) {
        best = ob;
        qsel = oq;
        kmin = ok;
        bs = os;
      }
    }
  } else {
    best = BEST[0];
#pragma unroll
    for (int c = 1; c < C; ++c) best = max(best, BEST[c]);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      best = max(best, __shfl_xor_sync(kFull, best, off, G));
    kmin = 1 << 30;
    qsel = -1;
    bs = 0;
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
  }
  if (gl == 0 && live) {
    // The rider's halves: (qs, ts) of a start, (n_diag, matches) of stats.
    const int hi = (int)((uint32_t)bs >> 16);
    const int lo = (int)((uint32_t)bs & 0xFFFFu);
    o[0] = best;
    o[1] = kStats ? lo : hi;
    o[2] = kStats ? hi : lo;
    o[3] = qsel;
    o[4] = qsel + kmin;
    o[5] = 0;
    o[6] = 0;
    o[7] = 0;
  }
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


// One problem group of a pre-gathered entry (K4, A1, G1): problem p's
// windows are q[p] (M bytes) and t[p] (M + G * C bytes). Where `skip`
// holds, the warp runs up to its problems' last read code other than 4
// (coded_rows), rounded up to C; otherwise every one of the M rows.
template <int G, int C, bool kWide, bool kStats, bool kRowEnd>
__device__ __forceinline__ void gathered_entry(const int8_t* __restrict__ q,
                                               const int8_t* __restrict__ t,
                                               int32_t* __restrict__ out,
                                               int P, int M, bool skip,
                                               int match, int mismatch,
                                               int oe, int ext) {
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
  dp_body<G, C, kWide, kStats, kRowEnd>(src, warp_rows<C>(own_rows, M, skip),
                                        gl, live, match, mismatch, oe, ext,
                                        out + 8 * (size_t)p);
}


// One problem group of a fused-fetch entry (K3, A1's flat entry): problem
// p's windows are reads[q_start[p] + i] (sentinel at i >= m[p]) and
// panel[t_start[p] + j] (sentinel outside [t_lo[p], t_hi[p]) and outside
// either buffer). Where `skip` holds, the warp runs up to its problems'
// largest min(m, bucket), rounded up to C; otherwise every one of the
// bucket rows.
template <int G, int C, bool kWide, bool kStats, bool kRowEnd>
__device__ __forceinline__ void flat_entry(
    const int8_t* __restrict__ reads, long long n_reads,
    const int8_t* __restrict__ panel, long long n_panel,
    const int32_t* __restrict__ q_start, const int32_t* __restrict__ t_start,
    const int32_t* __restrict__ m, const int32_t* __restrict__ t_lo,
    const int32_t* __restrict__ t_hi, int32_t* __restrict__ out, int P,
    int bucket, bool skip, int match, int mismatch, int oe, int ext) {
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
  dp_body<G, C, kWide, kStats, kRowEnd>(
      src, warp_rows<C>(own_rows, bucket, skip), gl, live, match, mismatch,
      oe, ext, out + 8 * (size_t)p);
}


// Blocks for P problems of a build with G lanes per problem.
template <int G>
dim3 grid_for(int P) {
  constexpr int kPerBlock = kWarpsPerBlock * (32 / G);
  return dim3((P + kPerBlock - 1) / kPerBlock);
}


// Calls launch(G, C, kWide), each an integral constant, with the
// build of A1 (both entries) and G1 for the band (K4's layouts, 16 and 32
// lanes x 8 cells, at 128 and 256; 32 lanes x 16 cells at 512) and the
// scores, and returns the launch's CUDA error. The row count must be a
// multiple of the build's cells per lane.
template <class Launch>
int for_banded_build(int band, int rows, bool wide, Launch launch) {
  using C8 = std::integral_constant<int, kCells>;
  using C16 = std::integral_constant<int, 2 * kCells>;
  using G16 = std::integral_constant<int, 16>;
  using G32 = std::integral_constant<int, 32>;
  const auto with = [&](auto g, auto c) {
    if (rows % decltype(c)::value != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    wide ? launch(g, c, std::true_type{}) : launch(g, c, std::false_type{});
    return static_cast<int>(cudaGetLastError());
  };
  switch (band) {
    case 128: return with(G16{}, C8{});
    case 256: return with(G32{}, C8{});
    case 512: return with(G32{}, C16{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// The narrow build also packs (value, lane) into one int for its scan,
// which gap scores in int8 keep far inside int32.
bool wide_build(int match, int mismatch, int oe, int ext, int rows,
                int band) {
  return needs_wide(match, mismatch, oe, ext, rows, band) || !fits_int8(oe) ||
         !fits_int8(ext);
}


}  // namespace
