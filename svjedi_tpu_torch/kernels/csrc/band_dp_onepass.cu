// One-pass banded affine-gap local alignment: score, start and end.
//
// Replaces two Pallas TPU kernels that share one DP:
//   svjedi_tpu/kernels/band_dp_dma.py:_kernel (band_dp_dma_raw), which
//     fetches each problem's windows itself from the flat read and panel
//     buffers -> entry band_dp_dma_kernel;
//   svjedi_tpu/kernels/band_dp.py:_kernel (band_dp_pallas), which reads
//     pre-gathered (P, M) / (P, M + band) windows -> entry
//     band_dp_onepass_kernel.
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
// The fused-fetch entry masks read rows at or beyond m and target
// positions outside [t_lo, t_hi) (and outside either buffer) to 4, and runs
// only min(m, bucket) rows: a row of sentinel reads lies strictly below an
// earlier cell, so it can neither reach the maximum nor change the picked
// cell. The pre-gathered entry runs all M rows.
//
// What bounds it on the H100: not memory. A row costs each problem one byte
// of read and one of target, while its band cells need ~25 integer ops each
// plus a prefix max across the band, carried as (value, start) pairs; the
// kernel is bound by integer issue and warp-shuffle latency, one dependent
// row after another.
//
// The design follows band_dp_v3.cu: one warp per problem, each lane holding
// 4 consecutive band cells (8 at band 256) of H, V, their packed starts,
// BEST, its start and row, and the sliding target window in registers. The
// horizontal gap, a log-shift cascade on the TPU, is the exact identity
// (htmp >= 0)
//   F[k] = ext*k + max_{j<k} (htmp[j] + oe - ext*(j+1)),
// a lane-local scan plus a 5-step __shfl_up_sync prefix max over (value,
// start) pairs in which the nearer source wins a tie. The start therefore
// rides along without dynamic register indexing, and te needs no register
// (te = qe + k). Every 32 rows the warp loads the next 32 read bytes and
// the next 32 incoming target bytes with one coalesced load each and hands
// them out by shuffle. There is no 1024-byte alignment or lane rotate: that
// was a Mosaic constraint on the TPU's DMA, which Hopper does not have.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

// Windows of the pre-gathered entry: one problem's rows of q and t.
struct Gathered {
  const int8_t* q;  // M bytes
  const int8_t* t;  // M + band bytes
  int rows;         // M
  int t_len;        // M + band
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

template <int C, class Src>
__device__ __forceinline__ void onepass_body(const Src& src, int rows,
                                             int lane, int match,
                                             int mismatch, int oe, int ext,
                                             int32_t* __restrict__ out) {
  constexpr int B = 32 * C;
  const int k0 = lane * C;
  int H[C], V[C], SH[C], SV[C], BEST[C], BS[C], BQE[C], T[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;
    V[c] = kNeg;
    SH[c] = k0 + c;  // packed (0 << 16) | k
    SV[c] = k0 + c;
    BEST[c] = 0;
    BS[c] = 0;
    BQE[c] = -1;
    T[c] = src.t_at(k0 + c);
  }

  int qbuf = 4, tbuf = 4;
  for (int i = 0; i < rows; ++i) {
    const int r = i & 31;
    if (r == 0) {  // next 32 read bytes and the targets entering at i+B..
      qbuf = src.q_at(i + lane);
      tbuf = src.t_at(i + B + lane);
    }
    const int qi = __shfl_sync(kFull, qbuf, r);

    // Vertical parents (cell k+1): the lane's next cell or the next lane's
    // first.
    int h_next = __shfl_down_sync(kFull, H[0], 1);
    int v_next = __shfl_down_sync(kFull, V[0], 1);
    int sh_next = __shfl_down_sync(kFull, SH[0], 1);
    int sv_next = __shfl_down_sync(kFull, SV[0], 1);
    if (lane == 31) {
      h_next = kNeg;
      v_next = kNeg;
      sh_next = 0;
      sv_next = 0;
    }
    int htmp[C], st[C], vnew[C], svnew[C], xv[C], xs[C];
    int run_v = kNeg, run_s = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int h_up = (c + 1 < C) ? H[c + 1] : h_next;
      const int v_up = (c + 1 < C) ? V[c + 1] : v_next;
      const int sh_up = (c + 1 < C) ? SH[c + 1] : sh_next;
      const int sv_up = (c + 1 < C) ? SV[c + 1] : sv_next;
      const int v_open = h_up + oe;
      const int v_ext = v_up + ext;
      vnew[c] = max(v_open, v_ext);
      svnew[c] = (v_open >= v_ext) ? sh_up : sv_up;
      const int sub = (qi == T[c] && qi < 4) ? match : mismatch;
      const int diag = H[c] + sub;
      int h = max(diag, vnew[c]);
      int s = (diag >= vnew[c]) ? SH[c] : svnew[c];
      if (h <= 0) {
        h = 0;
        s = ((i + 1) << 16) + (i + 1) + k0 + c;
      }
      htmp[c] = h;
      st[c] = s;
      // Exclusive lane-local prefix of the F sources; the nearer wins ties.
      xv[c] = run_v;
      xs[c] = run_s;
      const int w = h + oe - ext * (k0 + c + 1);
      if (w >= run_v) {
        run_v = w;
        run_s = s;
      }
    }
    // Warp-wide inclusive prefix max of the lane totals (a farther lane
    // must be strictly better), then exclusive.
    int iv = run_v, is = run_s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ov = __shfl_up_sync(kFull, iv, off);
      const int os = __shfl_up_sync(kFull, is, off);
      if (lane >= off && ov > iv) {
        iv = ov;
        is = os;
      }
    }
    int ev = __shfl_up_sync(kFull, iv, 1);
    int es = __shfl_up_sync(kFull, is, 1);
    if (lane == 0) {
      ev = kNeg;
      es = 0;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      const bool local = xv[c] >= ev;  // the lane's own sources are nearer
      const int F = ext * k + (local ? xv[c] : ev);
      int hn = htmp[c];
      int sn = st[c];
      if (k > 0 && F > hn) {
        hn = F;
        sn = local ? xs[c] : es;
      }
      if (hn > BEST[c]) {
        BEST[c] = hn;
        BS[c] = sn;
        BQE[c] = i;
      }
      H[c] = hn;
      SH[c] = sn;
      V[c] = vnew[c];
      SV[c] = svnew[c];
    }
    // Slide the target window: T[k] <- t[i + 1 + k].
    int t_next = __shfl_down_sync(kFull, T[0], 1);
    const int t_in = __shfl_sync(kFull, tbuf, r);
    if (lane == 31) t_next = t_in;
#pragma unroll
    for (int c = 0; c + 1 < C; ++c) T[c] = T[c + 1];
    T[C - 1] = t_next;
  }

  int best = BEST[0];
#pragma unroll
  for (int c = 1; c < C; ++c) best = max(best, BEST[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, off));
  int kmin = 1 << 30;
  int bs = 0;
  int bqe = -1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (BEST[c] == best && k0 + c < kmin) {
      kmin = k0 + c;
      bs = BS[c];
      bqe = BQE[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(kFull, kmin, off);
    const int os = __shfl_xor_sync(kFull, bs, off);
    const int oq = __shfl_xor_sync(kFull, bqe, off);
    if (ok < kmin) {
      kmin = ok;
      bs = os;
      bqe = oq;
    }
  }
  if (lane == 0) {
    out[0] = best;
    out[1] = bs >> 16;
    out[2] = bs & 0xFFFF;
    out[3] = bqe;
    out[4] = bqe + kmin;
    out[5] = 0;
    out[6] = 0;
    out[7] = 0;
  }
}

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_onepass_kernel(const int8_t* __restrict__ q,
                       const int8_t* __restrict__ t,
                       int32_t* __restrict__ out, int P, int M, int match,
                       int mismatch, int oe, int ext) {
  constexpr int B = 32 * C;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;
  const Gathered src{q + (size_t)p * M, t + (size_t)p * (M + B), M, M + B};
  onepass_body<C>(src, M, threadIdx.x & 31, match, mismatch, oe, ext,
                  out + 8 * (size_t)p);
}

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_dma_kernel(const int8_t* __restrict__ reads, long long n_reads,
                   const int8_t* __restrict__ panel, long long n_panel,
                   const int32_t* __restrict__ q_start,
                   const int32_t* __restrict__ t_start,
                   const int32_t* __restrict__ m,
                   const int32_t* __restrict__ t_lo,
                   const int32_t* __restrict__ t_hi,
                   int32_t* __restrict__ out, int P, int bucket, int match,
                   int mismatch, int oe, int ext) {
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;
  const int rows = max(0, min(m[p], bucket));
  const Flat src{reads,
                 n_reads,
                 (long long)q_start[p],
                 rows,
                 panel,
                 (long long)t_start[p],
                 max((long long)t_lo[p], 0LL),
                 min((long long)t_hi[p], n_panel)};
  onepass_body<C>(src, rows, threadIdx.x & 31, match, mismatch, oe, ext,
                  out + 8 * (size_t)p);
}

dim3 grid_for(int P) {
  return dim3((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int band_dp_onepass_launch(const void* q, const void* t, void* out,
                                      int P, int M, int band, int match,
                                      int mismatch, int oe, int ext,
                                      void* stream) {
  if (P <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const int8_t* tt = static_cast<const int8_t*>(t);
  int32_t* o = static_cast<int32_t*>(out);
  switch (band) {
    case 128:
      band_dp_onepass_kernel<4><<<grid_for(P), block, 0, s>>>(
          qq, tt, o, P, M, match, mismatch, oe, ext);
      break;
    case 256:
      band_dp_onepass_kernel<8><<<grid_for(P), block, 0, s>>>(
          qq, tt, o, P, M, match, mismatch, oe, ext);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* rd = static_cast<const int8_t*>(reads);
  const int8_t* pn = static_cast<const int8_t*>(panel);
  const int32_t* qs = static_cast<const int32_t*>(q_start);
  const int32_t* ts = static_cast<const int32_t*>(t_start);
  const int32_t* mm = static_cast<const int32_t*>(m);
  const int32_t* lo = static_cast<const int32_t*>(t_lo);
  const int32_t* hi = static_cast<const int32_t*>(t_hi);
  int32_t* o = static_cast<int32_t*>(out);
  switch (band) {
    case 128:
      band_dp_dma_kernel<4><<<grid_for(P), block, 0, s>>>(
          rd, n_reads, pn, n_panel, qs, ts, mm, lo, hi, o, P, bucket, match,
          mismatch, oe, ext);
      break;
    case 256:
      band_dp_dma_kernel<8><<<grid_for(P), block, 0, s>>>(
          rd, n_reads, pn, n_panel, qs, ts, mm, lo, hi, o, P, bucket, match,
          mismatch, oe, ext);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
