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
// The formulation the kernel computes, equal to that rule: a window is w
// consecutive k-mer starts that all lie inside one real read; p is emitted
// iff it is the leftmost minimum of (h, position) over some window and h[p]
// is not INVALID (an INVALID hash inside a read is larger than every real
// one, so it never wins). If a + b >= w - 1 the window starting at
// p - min(a, w - 1) is such a window; conversely a window's leftmost
// minimum has its w - 1 neighbours inside the window on its two runs.
// Reads with fewer than w k-mers have no window and keep their bits clear.
//
// What bounds it on the H100: integer issue. Per position: the two k-mers
// (two funnel shifts, a shift, a mask), the N and read-boundary tests
// (shifts and masks of bit words), the read-range tests, the palindrome
// test, min, the 8-op fmix32 and a select, then the window minimum (a
// prefix and a suffix compare-select, one compare-select per window and
// its validity compares) against one byte read and one bit written: 37
// int32 operations as chip_smoke.py counts them
// (SCAN_OPS_WINDOW_PER_POSITION) against ~1.1 bytes, far above the card's
// ~5 ops per byte. What the kernel loses to that bound is latency: each
// tile runs its phases one after another between barriers (PERF.md
// section 6 gives the phases' times).
//
// The design (tiles of 4096 positions, with a halo of w - 1 positions on
// each side and k - 1 more bases on the right; persistent blocks of 256
// threads, as many as the card holds at once, each walking over tiles
// with ~50 KB of dynamic shared memory):
//   1. The tile's codes are loaded once (16-byte loads where aligned) and
//      packed per 16 bases into three words in shared memory: the 2-bit
//      codes big-endian (first base in the top bits), the complemented
//      codes little-endian, and an N bit mask (low half) with a read-start
//      bit mask (high half: the offsets inside the tile, found by two
//      warps' 32-way searches while the others pack; usually none or one).
//      A warp turns the start masks into per-word prefix counts.
//   2. Each position's k-mers come from funnel shifts of two adjacent
//      words, with no per-thread warm-up: fwd from the big-endian codes,
//      rc from the little-endian complements (its 2-bit groups are already
//      in reverse order). The N and boundary tests are shifts of the bit
//      words; a position inside a real read gets a 16-bit segment tag (the
//      starts before it, by popcount), others 0xffff.
//   3. The window minima are van Herk/Gil-Werman: prefix and suffix argmins
//      in blocks of w positions, and per window start s the left of
//      suffix(s) and prefix(s + w - 1) at a tie, so every thread runs the
//      same steps: no data-dependent run loops. A window is valid where the
//      segment tags of its two ends are equal (and not 0xffff); its argmin
//      marks a byte in shared memory (several windows may mark the same
//      position with the same value).
//   4. A warp's 32 consecutive positions become one __ballot_sync word,
//      staged in shared memory; the tile's words are stored coalesced, as
//      little-endian bytes (bit p & 7 of byte p >> 3).
// All arithmetic is uint32_t, so the wrap-around multiplies and shifts are
// JAX's uint32 ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // k-mer positions per block, a multiple of 32
constexpr int kMaxK = 16;    // a k-mer's 2k bits must fit a uint32_t
constexpr int kMaxW = 64;
constexpr int kMaxHashes = kTile + 2 * (kMaxW - 1);
// Words of 16 bases over the codes (hashes + k - 1), a word of slack on
// each side for an unaligned start, and one for the funnel's second word.
constexpr int kMaxWords = (kMaxHashes + kMaxK - 1) / 16 + 3;
constexpr uint32_t kInvalid = 0xffffffffu;
constexpr uint16_t kNoSeg = 0xffff;
constexpr unsigned kFull = 0xffffffffu;

// The block's shared memory, dynamic (more than 48 KB).
struct Smem {
  uint32_t fwd[kMaxWords];  // 2-bit codes, first base in the top bits
  uint32_t cmp[kMaxWords];  // complements, first base at bit 0
  uint32_t ns[kMaxWords];   // bit j: base j is an N; bit 16 + j: a read
                            // starts at base j
  uint32_t hash[kMaxHashes];
  uint16_t cnt[kMaxWords];  // read starts in earlier words
  uint16_t seg[kMaxHashes];
  uint16_t pre[kMaxHashes];
  uint16_t suf[kMaxHashes];
  uint8_t emit[kMaxHashes];
  uint32_t bits[kTile / 32];  // the tile's bitmask, stored coalesced
  int lo, hi;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// Number of offsets[0, n) that are <= x (offsets sorted), by one warp: a
// 32-way search, each step one load per lane and a ballot (3 dependent
// loads for 16k offsets where a binary search takes 15).
__device__ __forceinline__ int warp_count_le(const int32_t* offsets, int n,
                                             long long x, int lane) {
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + step * (lane + 1) - 1;
    const int c =
        __popc(__ballot_sync(kFull, idx < hi && offsets[idx] <= x));
    const int nlo = lo + step * c;
    hi = min(nlo + step - 1, hi);
    lo = nlo;
  }
  const int idx = lo + lane;
  return lo + __popc(__ballot_sync(kFull, idx < hi && offsets[idx] <= x));
}

// floor(x / 16) for a possibly negative x.
__device__ __forceinline__ long long word_of(long long x) { return x >> 4; }

// One tile: kTile k-mer positions from tile0, their bits into out.
__device__ __forceinline__ void scan_tile(
    Smem& sm, int tid, long long tile0, const int8_t* __restrict__ codes,
    const int32_t* __restrict__ offsets, int n_reads, long long n_cap, int k,
    int w, bool vec, uint8_t* __restrict__ out) {
  const long long nk = n_cap - k + 1;
  const int halo = w - 1;
  const long long g0 = tile0 - halo;  // position of hash slot 0
  const int n_hash = kTile + 2 * halo;
  const long long g_end = g0 + n_hash + k - 1;  // codes [g0, g_end)
  const long long wb = word_of(g0);             // word 0's first base / 16
  const int n_words = (int)(word_of(g_end - 1) - wb) + 2;

  // 1. Two warps find the offsets inside the tile's codes (indices
  // [lo, hi)) while the others pack 16 bases per word.
  if (tid < 64) {
    const int c = warp_count_le(offsets, n_reads + 1,
                                tid < 32 ? g0 - 1 : g_end - 1, tid & 31);
    if (tid == 0) sm.lo = c;
    if (tid == 32) sm.hi = c;
  }
  for (int x = tid; x < n_hash; x += kThreads) sm.emit[x] = 0;
  for (int i = tid - 64; tid >= 64 && i < n_words; i += kThreads - 64) {
    const long long b0 = (wb + i) * 16;
    int8_t c16[16];
    if (vec && b0 >= 0 && b0 + 16 <= n_cap) {
      *reinterpret_cast<uint4*>(c16) =
          *reinterpret_cast<const uint4*>(codes + b0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long g = b0 + j;
        c16[j] = (g >= 0 && g < n_cap) ? codes[g] : (int8_t)4;
      }
    }
    uint32_t f = 0, cm = 0, nb = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t c = (uint32_t)(c16[j] & 3);
      f |= c << (30 - 2 * j);
      cm |= (3u - c) << (2 * j);
      nb |= (uint32_t)!(c16[j] < 4) << j;
    }
    sm.fwd[i] = f;
    sm.cmp[i] = cm;
    sm.ns[i] = nb;
  }
  __syncthreads();

  // The read starts (usually none or one) into the words' high halves, and
  // the starts before each word: one warp, a few words a lane.
  if (tid < 32) {
    for (int r = sm.lo + tid; r < sm.hi; r += 32) {
      const long long off = (long long)offsets[r] - wb * 16;
      atomicOr(&sm.ns[off >> 4], 1u << (16 + (off & 15)));
    }
    __syncwarp();
    const int per = (n_words + 31) / 32;
    int sum = 0;
    for (int i = tid * per; i < min(n_words, tid * per + per); ++i)
      sum += __popc(sm.ns[i] >> 16);
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (tid >= off) incl += v;
    }
    int run = incl - sum;
    for (int i = tid * per; i < min(n_words, tid * per + per); ++i) {
      sm.cnt[i] = (uint16_t)run;
      run += __popc(sm.ns[i] >> 16);
    }
  }
  __syncthreads();

  // 2. Hash and segment tag of every slot.
  const uint32_t mask2k = k == 16 ? kFull : (1u << (2 * k)) - 1u;
  const uint32_t mask_k = (1u << k) - 1u;
  const uint32_t mask_k1 = (1u << (k - 1)) - 1u;
  // Slots whose k-mer lies in [offsets[0], min(offsets[n_reads], n_cap)).
  const long long lo_base = offsets[0];
  const long long hi_base = min((long long)offsets[n_reads], n_cap);
  const int x_lo = (int)max(0LL, min((long long)n_hash, lo_base - g0));
  const int x_hi = (int)max(0LL, min((long long)n_hash, hi_base - k + 1 - g0));
  const int base_w = (int)(g0 - wb * 16);  // slot 0's base in word 0
  for (int x = tid; x < n_hash; x += kThreads) {
    const int pw = x + base_w;
    const int i = pw >> 4;
    const int o = pw & 15;
    const uint32_t fwd =
        __funnelshift_l(sm.fwd[i + 1], sm.fwd[i], 2 * o) >> (32 - 2 * k);
    const uint32_t rc =
        __funnelshift_r(sm.cmp[i], sm.cmp[i + 1], 2 * o) & mask2k;
    const uint32_t ns0 = sm.ns[i], ns1 = sm.ns[i + 1];
    const uint32_t n2 = (ns0 & 0xffffu) | (ns1 << 16);
    const uint32_t st = (ns0 >> 16) | (ns1 & 0xffff0000u);
    const bool in_read =
        x >= x_lo && x < x_hi && ((st >> (o + 1)) & mask_k1) == 0;
    const bool ok = in_read && ((n2 >> o) & mask_k) == 0 && fwd != rc;
    sm.hash[x] = ok ? fmix32(min(fwd, rc)) : kInvalid;
    sm.seg[x] = in_read ? (uint16_t)(sm.cnt[i] +
                                     __popc((ns0 >> 16) & ((2u << o) - 1u)))
                        : kNoSeg;
  }
  __syncthreads();

  // 3a. Prefix and suffix argmins in blocks of w slots (ties: the left).
  for (int b = tid; b * w < n_hash; b += kThreads) {
    const int x0 = b * w;
    const int x1 = min(x0 + w, n_hash);
    int best = x0;
    uint32_t hb = sm.hash[x0];
    sm.pre[x0] = (uint16_t)x0;
#pragma unroll 4
    for (int x = x0 + 1; x < x1; ++x) {
      const uint32_t h = sm.hash[x];
      if (h < hb) {
        hb = h;
        best = x;
      }
      sm.pre[x] = (uint16_t)best;
    }
    best = x1 - 1;
    hb = sm.hash[best];
    sm.suf[best] = (uint16_t)best;
#pragma unroll 4
    for (int x = x1 - 2; x >= x0; --x) {
      const uint32_t h = sm.hash[x];
      if (h <= hb) {
        hb = h;
        best = x;
      }
      sm.suf[x] = (uint16_t)best;
    }
  }
  __syncthreads();

  // 3b. Every window starting at slot s <= kTile + w - 2 (its last slot is
  // inside the hashes): mark its argmin where the window lies in one read.
  for (int s = tid; s + w - 1 < n_hash; s += kThreads) {
    const int e = s + w - 1;
    const uint16_t seg = sm.seg[s];
    const int ms = sm.suf[s], me = sm.pre[e];
    const uint32_t hs = sm.hash[ms], he = sm.hash[me];
    const int m = hs <= he ? ms : me;
    const uint32_t hm = hs <= he ? hs : he;
    if (seg != kNoSeg && seg == sm.seg[e] && hm != kInvalid) sm.emit[m] = 1;
  }
  __syncthreads();

  // 4. Emission: a warp's 32 consecutive positions per ballot, staged in
  // shared memory and stored as whole words (bit p & 7 of byte p >> 3).
  for (int base = 0; base < kTile; base += kThreads) {
    const int t = base + tid;
    const bool emit = tile0 + t < nk && sm.emit[t + halo];
    const uint32_t bits = __ballot_sync(kFull, emit);
    if ((tid & 31) == 0) sm.bits[t >> 5] = bits;
  }
  __syncthreads();
  const long long n_bytes = n_cap >> 3;
  for (int j = tid; j < kTile / 32; j += kThreads) {
    const long long byte0 = (tile0 >> 3) + 4 * j;
    if (byte0 + 4 <= n_bytes) {
      *reinterpret_cast<uint32_t*>(out + byte0) = sm.bits[j];
    } else {
      for (long long byte = byte0; byte < n_bytes; ++byte)
        out[byte] = (uint8_t)(sm.bits[j] >> (8 * (byte - byte0)));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dev_scan_kernel(const int8_t* __restrict__ codes,
                const int32_t* __restrict__ offsets, int n_reads,
                long long n_cap, int k, int w, bool vec, long long n_tiles,
                uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  // Persistent blocks: each walks over tiles, reusing its shared memory.
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    scan_tile(sm, tid, tile * kTile, codes, offsets, n_reads, n_cap, k, w,
              vec, out);
    __syncthreads();
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
  const long long n_tiles = (n_cap + kTile - 1) / kTile;
  const bool vec = reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  // Above 48 KB of shared memory a kernel must ask (per device: each call).
  const cudaError_t attr = cudaFuncSetAttribute(
      dev_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // As many blocks as the card holds at once.
  int device = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dev_scan_kernel,
                                                kThreads, sizeof(Smem));
  const long long slots = (long long)max(1, n_sm * per_sm);
  const unsigned grid = (unsigned)min(n_tiles, slots);
  dev_scan_kernel<<<grid, kThreads, sizeof(Smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(offsets),
      n_reads, n_cap, k, w, vec, n_tiles, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
