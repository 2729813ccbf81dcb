// Minimizer emission bitmask of every read in a chunk (the device seed scan).
//
// Replaces svjedi_tpu/align/dev_scan.py:_scan_kernel, an XLA program (not
// Pallas). Same contract: codes = reads2[0, n_cap) (int8, 0-3 bases, 4 for
// N; the padding past the reads is 0), offsets = the (n_reads + 1,) int32
// read boundaries. Base p belongs to read upper_bound(offsets, p) - 1 (so
// an empty read, a repeated offset, owns no base, and the padding belongs
// to read n_reads). For every k-mer start p < nk = n_cap - k + 1:
//   fwd = sum_j c[p+j] << 2(k-1-j), rc = sum_j (3 - c[p+j]) << 2j (c = code & 3)
//   h   = fmix32(min(fwd, rc)), or INVALID (0xffffffff) where the k-mer
//         holds an N, is a palindrome (fwd == rc) or leaves its read
//         (krid = -1; the padding's read n_reads counts as leaving);
//   a   = run of predecessors p-1, p-2, .. of the same krid with h > h[p],
//   b   = run of successors of the same krid with h >= h[p], both <= w-1;
// p is emitted iff h[p] != INVALID and a + b >= w - 1 (it is the leftmost
// minimum of some w-window of its read). The output is the (n_cap / 8,)
// uint8 bitmask, bit p & 7 of byte p >> 3.
//
// What bounds it on the H100: integer issue. Per position the work is
// about k shift-ors to build the two k-mers (the kernel rolls them: two
// shift-ors and a mask per new base once a thread's first k-mer is
// built), the 6-op fmix32 (plus its three shifts), a few compares for
// validity and the read id, and up to 2(w - 1) compare pairs for the two
// runs, against one byte read and one bit written: ~40 int32 operations
// against ~1.1 bytes, far above the card's ~5 ops per byte of balance.
//
// The design. One block of 256 threads per tile of 1024 k-mer positions.
// The tile's codes, with a halo of w - 1 positions to the left and
// w - 1 + k - 1 bases to the right, are staged once in shared memory by
// coalesced loads, with each base's read id (a binary search over only
// the offsets that fall inside the tile, usually none or one). Each thread
// then rolls the k-mers over a few consecutive positions and stores each
// position's hash and krid in shared memory, once; a position outside
// [0, nk) stores krid -2, which no real k-mer has, so runs stop there.
// Each position then reads its two runs from shared memory, and a warp's
// 32 consecutive positions become one __ballot_sync word, stored as 4
// little-endian bytes (bit p & 7 of byte p >> 3). All arithmetic is
// uint32_t, so the wrap-around multiplies and shifts are JAX's uint32 ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // k-mer positions per block, a multiple of 32
constexpr int kMaxK = 16;    // a k-mer's 2k bits must fit a uint32_t
constexpr int kMaxW = 64;
constexpr int kMaxHashes = kTile + 2 * (kMaxW - 1);
constexpr int kMaxCodes = kMaxHashes + kMaxK - 1;
constexpr uint32_t kInvalid = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// Number of offsets[lo, hi) that are <= x (offsets sorted).
__device__ __forceinline__ int count_le(const int32_t* offsets, int lo, int hi,
                                        long long x) {
  const int base = lo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo - base;
}

__global__ void __launch_bounds__(kThreads)
dev_scan_kernel(const int8_t* __restrict__ codes,
                const int32_t* __restrict__ offsets, int n_reads,
                long long n_cap, int k, int w, uint8_t* __restrict__ out) {
  __shared__ int8_t s_code[kMaxCodes];
  __shared__ int32_t s_rid[kMaxCodes];
  __shared__ uint32_t s_hash[kMaxHashes];
  __shared__ int32_t s_krid[kMaxHashes];
  __shared__ int s_lo, s_hi;

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * kTile;
  const long long nk = n_cap - k + 1;
  const int halo = w - 1;
  const long long g0 = tile0 - halo;  // position of hash / code slot 0
  const int n_hash = kTile + 2 * halo;
  const int n_code = n_hash + k - 1;

  // The read ids of the tile's bases lie in [s_lo, s_hi]: only the offsets
  // between them need a search per base. Two warps search for the two ends.
  if (tid == 0) {
    s_lo = count_le(offsets, 0, n_reads + 1, g0 < 0 ? 0 : g0) - 1;
  } else if (tid == 32) {
    const long long last = min(g0 + n_code - 1, n_cap - 1);
    s_hi = count_le(offsets, 0, n_reads + 1, last) - 1;
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  for (int x = tid; x < n_code; x += kThreads) {
    const long long g = g0 + x;
    const bool in = g >= 0 && g < n_cap;
    s_code[x] = in ? codes[g] : (int8_t)4;
    s_rid[x] = in ? lo + count_le(offsets, lo + 1, hi + 1, g) : -1;
  }
  __syncthreads();

  // Hashes: each thread rolls the k-mers over `per` consecutive slots.
  const int per = (n_hash + kThreads - 1) / kThreads;
  const int i0 = tid * per;
  const int i1 = min(i0 + per, n_hash);
  if (i0 < i1) {
    const uint32_t mask = k == 16 ? kFull : (1u << (2 * k)) - 1u;
    const int top = 2 * (k - 1);
    uint32_t fwd = 0, rc = 0;
    int last_n = i0 - 1;  // slot of the last N pushed
    for (int j = i0; j < i0 + k - 1; ++j) {
      const int8_t code = s_code[j];
      const uint32_t c = (uint32_t)(code & 3);
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((3u - c) << top);
      if (!(code < 4)) last_n = j;
    }
    for (int i = i0; i < i1; ++i) {
      const int8_t code = s_code[i + k - 1];
      const uint32_t c = (uint32_t)(code & 3);
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((3u - c) << top);
      if (!(code < 4)) last_n = i + k - 1;
      const long long q = g0 + i;
      int krid = -2;
      uint32_t h = kInvalid;
      if (q >= 0 && q < nk) {
        const int r = s_rid[i];
        krid = (r == s_rid[i + k - 1] && r < n_reads) ? r : -1;
        if (last_n < i && fwd != rc && krid >= 0) h = fmix32(min(fwd, rc));
      }
      s_hash[i] = h;
      s_krid[i] = krid;
    }
  }
  __syncthreads();

  // Emission: a warp's 32 consecutive positions per ballot.
  const int lane = tid & 31;
  for (int base = 0; base < kTile; base += kThreads) {
    const int t = base + tid;
    const long long p = tile0 + t;
    const int i = t + halo;
    bool emit = false;
    const uint32_t h = s_hash[i];
    if (p < nk && h != kInvalid) {
      const int kr = s_krid[i];
      int a = 0, b = 0;
      while (a < halo && s_krid[i - a - 1] == kr && s_hash[i - a - 1] > h) ++a;
      while (b < halo && s_krid[i + b + 1] == kr && s_hash[i + b + 1] >= h) ++b;
      emit = a + b >= halo;
    }
    const uint32_t bits = __ballot_sync(kFull, emit);
    const long long p0 = p - lane;  // a multiple of 32
    if (lane == 0 && p0 < n_cap) {
      if (p0 + 32 <= n_cap) {
        *reinterpret_cast<uint32_t*>(out + (p0 >> 3)) = bits;
      } else {
        for (long long byte = p0 >> 3; byte < (n_cap >> 3); ++byte)
          out[byte] = (uint8_t)(bits >> (8 * (byte - (p0 >> 3))));
      }
    }
  }
}

}  // namespace

// codes: int8 (>= n_cap,), offsets: int32 (n_reads + 1,), out: uint8
// (n_cap / 8,), 4-byte aligned. n_cap % 8 == 0, 1 <= k <= 16, k <= n_cap,
// 1 <= w <= 64.
extern "C" int dev_scan_launch(const void* codes, const void* offsets,
                               int n_reads, long long n_cap, int k, int w,
                               void* out, void* stream) {
  if (n_cap <= 0 || n_cap % 8 != 0 || k < 1 || k > kMaxK || k > n_cap ||
      w < 1 || w > kMaxW || n_reads < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_cap + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dev_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(offsets),
      n_reads, n_cap, k, w, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
