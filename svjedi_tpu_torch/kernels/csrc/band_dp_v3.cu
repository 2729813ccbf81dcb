// Banded affine-gap local alignment, score and end only (the v3 forward pass).
//
// Replaces the Pallas TPU kernel svjedi_tpu/kernels/band_dp_v3.py:_kernel
// (with _kernel_body). Same contract: for each problem p, the windows
// qT[:, p] (bucket rows) and tT[:, p] (bucket + band rows) are int8 codes in
// a transposed (rows, P) layout, with sentinel 4 matching nothing. Cell
// (i, k) pairs read row i with target row i + k. Output per problem is
// (best score, qe, te = qe + k): a cell keeps the first row that reaches its
// best (strict >), and among cells tied at the maximum the lowest band
// offset k wins; a problem scoring 0 reports qe = te = -1. prefetch holds
// [n_valid] ++ one row bound per 128 problems (the JAX scalar-prefetch
// vector): problem p runs min(round_up(bound[p / 128], 8), bucket) rows,
// and problems at index >= n_valid are skipped and written (0, -1, -1).
//
// What bounds it on the H100: not memory. A row costs each problem one
// byte of q and one of t, while its 128 band cells need ~15 integer ops
// each plus a prefix max across the band, so the kernel is bound by
// integer issue and warp-shuffle latency, with one dependent row after
// another.
//
// The design: one warp per problem, each lane holding 4 consecutive band
// cells (8 at band 256) of H, V, BEST, BQE and the sliding target window in
// registers; nothing touches shared or device memory inside the row loop
// except the two input bytes. Vertical parents (cell k+1) come from the
// lane's own next cell or one __shfl_down_sync. The horizontal gap, a log
// shift cascade on the TPU, is the exact identity (htmp >= 0)
//   F[k] = ext*k + max_{j<k} (htmp[j] + oe - ext*(j+1)),
// i.e. a lane-local scan plus a 5-step __shfl_up_sync prefix max. Warps of
// a block take neighbouring problems, so a row's loads from the (rows, P)
// layout fall on neighbouring bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_v3_fwd_kernel(const int8_t* __restrict__ qT,
                      const int8_t* __restrict__ tT,
                      const int32_t* __restrict__ prefetch,
                      int32_t* __restrict__ out, int P, int bucket,
                      int match, int mismatch, int oe, int ext) {
  constexpr int B = 32 * C;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;
  if (p >= prefetch[0]) {
    if (lane == 0) {
      out[3 * p] = 0;
      out[3 * p + 1] = -1;
      out[3 * p + 2] = -1;
    }
    return;
  }
  const int bound = prefetch[1 + (p >> 7)];
  const int rows = max(0, min(((bound + 7) >> 3) << 3, bucket));
  const size_t stride = (size_t)P;
  const int k0 = lane * C;

  int H[C], V[C], BEST[C], BQE[C], T[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;
    V[c] = kNeg;
    BEST[c] = 0;
    BQE[c] = -1;
    T[c] = tT[(size_t)(k0 + c) * stride + p];
  }

  for (int i = 0; i < rows; ++i) {
    const int qi = qT[(size_t)i * stride + p];
    int h_next = __shfl_down_sync(kFull, H[0], 1);
    int v_next = __shfl_down_sync(kFull, V[0], 1);
    if (lane == 31) {
      h_next = kNeg;
      v_next = kNeg;
    }
    int htmp[C], vnew[C], excl_local[C];
    int run = kNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int h_up = (c + 1 < C) ? H[c + 1] : h_next;
      const int v_up = (c + 1 < C) ? V[c + 1] : v_next;
      vnew[c] = max(h_up + oe, v_up + ext);
      const int sub = (qi == T[c] && qi < 4) ? match : mismatch;
      htmp[c] = max(max(H[c] + sub, vnew[c]), 0);
      excl_local[c] = run;
      run = max(run, htmp[c] + oe - ext * (k0 + c + 1));
    }
    // Warp-wide inclusive prefix max of the lane totals, then exclusive.
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = k0 + c;
      const int F = (k == 0) ? kNeg : ext * k + max(excl, excl_local[c]);
      const int hn = max(htmp[c], F);
      if (hn > BEST[c]) {
        BEST[c] = hn;
        BQE[c] = i;
      }
      H[c] = hn;
      V[c] = vnew[c];
    }
    // Slide the target window: T[k] <- t[i + 1 + k].
    int t_next = __shfl_down_sync(kFull, T[0], 1);
    if (lane == 31) t_next = tT[(size_t)(i + B) * stride + p];
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
  int qsel = -1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (BEST[c] == best && k0 + c < kmin) {
      kmin = k0 + c;
      qsel = BQE[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(kFull, kmin, off);
    const int oq = __shfl_xor_sync(kFull, qsel, off);
    if (ok < kmin) {
      kmin = ok;
      qsel = oq;
    }
  }
  if (lane == 0) {
    out[3 * p] = best;
    out[3 * p + 1] = qsel;
    out[3 * p + 2] = qsel + kmin;
  }
}

}  // namespace

extern "C" int band_dp_v3_fwd_launch(const void* qT, const void* tT,
                                     const void* prefetch, void* out, int P,
                                     int bucket, int band, int match,
                                     int mismatch, int oe, int ext,
                                     void* stream) {
  if (P <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(qT);
  const int8_t* t = static_cast<const int8_t*>(tT);
  const int32_t* pf = static_cast<const int32_t*>(prefetch);
  int32_t* o = static_cast<int32_t*>(out);
  switch (band) {
    case 128:
      band_dp_v3_fwd_kernel<4><<<grid, block, 0, s>>>(
          q, t, pf, o, P, bucket, match, mismatch, oe, ext);
      break;
    case 256:
      band_dp_v3_fwd_kernel<8><<<grid, block, 0, s>>>(
          q, t, pf, o, P, bucket, match, mismatch, oe, ext);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svjt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
