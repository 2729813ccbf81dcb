// Copied verbatim from native/fastio.cpp.
// Native I/O hot path: FASTQ/FASTA(.gz) reading + 2-bit-friendly encoding.
//
// The reference pipeline's only native component is minigraph (C), which
// also owns gzip decompression of the read files (SURVEY §2.1). In this
// framework the compute path is JAX/Pallas on TPU; the native runtime piece
// is the host-side read loader feeding it: zlib streaming decompression,
// record parsing, and ASCII→code conversion (A,C,G,T → 0..3, other → 4) in
// one pass. Exposed as a C ABI consumed via ctypes
// (svjedi_tpu/utils/native.py) with a pure-Python fallback.
//
// Build: make -C native   (produces libsvtfastio.so)

#include <cmath>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Result {
  std::vector<std::string> names;
  std::vector<int8_t> codes;
  std::vector<int64_t> offsets;  // size = names.size() + 1
};

int8_t g_lut[256];

struct LutInit {
  LutInit() {
    memset(g_lut, 4, sizeof(g_lut));
    g_lut[(unsigned)'A'] = g_lut[(unsigned)'a'] = 0;
    g_lut[(unsigned)'C'] = g_lut[(unsigned)'c'] = 1;
    g_lut[(unsigned)'G'] = g_lut[(unsigned)'g'] = 2;
    g_lut[(unsigned)'T'] = g_lut[(unsigned)'t'] = 3;
  }
} g_lut_init;

class LineReader {
 public:
  explicit LineReader(gzFile file) : file_(file), pos_(0), len_(0), eof_(false) {}

  // Reads one line (without trailing newline) into out. Returns false at EOF.
  bool getline(std::string* out) {
    out->clear();
    for (;;) {
      if (pos_ == len_) {
        if (eof_) return !out->empty();
        len_ = gzread(file_, buf_, sizeof(buf_));
        pos_ = 0;
        if (len_ <= 0) {
          eof_ = true;
          len_ = 0;
          return !out->empty();
        }
      }
      char* nl = static_cast<char*>(memchr(buf_ + pos_, '\n', len_ - pos_));
      if (nl != nullptr) {
        size_t n = nl - (buf_ + pos_);
        out->append(buf_ + pos_, n);
        pos_ += n + 1;
        if (!out->empty() && out->back() == '\r') out->pop_back();
        return true;
      }
      out->append(buf_ + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gzFile file_;
  char buf_[1 << 16];
  int pos_, len_;
  bool eof_;
};

void append_encoded(const std::string& seq, std::vector<int8_t>* codes) {
  size_t old = codes->size();
  codes->resize(old + seq.size());
  int8_t* dst = codes->data() + old;
  for (size_t i = 0; i < seq.size(); ++i) {
    dst[i] = g_lut[(unsigned char)seq[i]];
  }
}

std::string first_token(const std::string& header, size_t skip) {
  size_t end = header.find_first_of(" \t", skip);
  if (end == std::string::npos) return header.substr(skip);
  return header.substr(skip, end - skip);
}

}  // namespace

extern "C" {

// Returns an opaque Result*, or nullptr on open/parse failure.
void* svt_read_sequences(const char* path) {
  gzFile file = gzopen(path, "rb");
  if (file == nullptr) return nullptr;
  // Larger internal buffer helps gz throughput.
  gzbuffer(file, 1 << 20);

  LineReader reader(file);
  auto* result = new Result();
  result->offsets.push_back(0);

  std::string line;
  if (!reader.getline(&line)) {
    gzclose(file);
    return result;  // empty file → empty result
  }

  if (!line.empty() && line[0] == '@') {
    // FASTQ: header / seq / '+' / quals.
    std::string seq, plus, quals;
    for (;;) {
      if (line.empty() || line[0] != '@') break;
      if (!reader.getline(&seq)) break;
      reader.getline(&plus);
      reader.getline(&quals);
      result->names.push_back(first_token(line, 1));
      append_encoded(seq, &result->codes);
      result->offsets.push_back((int64_t)result->codes.size());
      if (!reader.getline(&line)) break;
    }
  } else if (!line.empty() && line[0] == '>') {
    // FASTA (possibly multi-line sequences).
    std::string name = first_token(line, 1);
    for (;;) {
      bool more = reader.getline(&line);
      if (!more || (!line.empty() && line[0] == '>')) {
        result->names.push_back(name);
        result->offsets.push_back((int64_t)result->codes.size());
        if (!more) break;
        name = first_token(line, 1);
      } else {
        append_encoded(line, &result->codes);
      }
    }
  } else {
    delete result;
    gzclose(file);
    return nullptr;
  }

  gzclose(file);
  return result;
}

int64_t svt_result_n_reads(void* handle) {
  return (int64_t) static_cast<Result*>(handle)->names.size();
}

int64_t svt_result_total_bases(void* handle) {
  return (int64_t) static_cast<Result*>(handle)->codes.size();
}

void svt_result_copy(void* handle, int8_t* codes_out, int64_t* offsets_out) {
  auto* r = static_cast<Result*>(handle);
  if (!r->codes.empty())
    memcpy(codes_out, r->codes.data(), r->codes.size());
  memcpy(offsets_out, r->offsets.data(), r->offsets.size() * sizeof(int64_t));
}

const char* svt_result_name(void* handle, int64_t i) {
  return static_cast<Result*>(handle)->names[i].c_str();
}

void svt_result_free(void* handle) { delete static_cast<Result*>(handle); }

// ---------------------------------------------------------------------------
// Streaming reader: bounded-memory chunked reading for genome-scale inputs.
//
// The whole-file svt_read_sequences keeps every base resident — ~36 GB of
// reads for a 12x human genome. The reference sidesteps this because
// minigraph streams the FASTQ internally (svjedi-graph.py:104 just pipes
// the path); this is the equivalent native streaming layer for our
// in-process aligner: open once, pull up to (max_reads, max_bases) records
// per call, each chunk a standalone Result consumed via the svt_result_*
// accessors and freed independently. Reads-resident memory is O(chunk).
// Chunk boundaries never split a record; concatenating all chunks is
// byte-identical to svt_read_sequences on the same file.
// ---------------------------------------------------------------------------

namespace {

struct Stream {
  gzFile file = nullptr;
  LineReader* reader = nullptr;
  int format = 0;        // 1 = FASTQ, 2 = FASTA, 0 = empty/unknown
  std::string pending;   // FASTQ: next header line; FASTA: next record name
  bool has_pending = false;
  bool bad = false;      // unrecognized leading line
};

}  // namespace

// Returns an opaque Stream*, or nullptr on open failure / unrecognized
// format (same acceptance rule as svt_read_sequences).
void* svt_stream_open(const char* path) {
  gzFile file = gzopen(path, "rb");
  if (file == nullptr) return nullptr;
  gzbuffer(file, 1 << 20);
  auto* s = new Stream();
  s->file = file;
  s->reader = new LineReader(file);
  std::string line;
  if (!s->reader->getline(&line)) {
    s->format = 0;  // empty file: first next() returns EOF
    return s;
  }
  if (!line.empty() && line[0] == '@') {
    s->format = 1;
    s->pending = line;
    s->has_pending = true;
  } else if (!line.empty() && line[0] == '>') {
    s->format = 2;
    s->pending = first_token(line, 1);
    s->has_pending = true;
  } else {
    delete s->reader;
    gzclose(file);
    delete s;
    return nullptr;
  }
  return s;
}

// Reads up to max_reads records (and stops early once max_bases bases are
// buffered; always at least one record). Returns a Result* for the
// svt_result_* accessors, or nullptr at EOF. max_reads/max_bases <= 0
// mean unbounded.
void* svt_stream_next(void* handle, int64_t max_reads, int64_t max_bases) {
  auto* s = static_cast<Stream*>(handle);
  if (s == nullptr || !s->has_pending) return nullptr;
  if (max_reads <= 0) max_reads = INT64_MAX;
  if (max_bases <= 0) max_bases = INT64_MAX;
  auto* result = new Result();
  result->offsets.push_back(0);
  std::string line, seq, plus, quals;
  if (s->format == 1) {
    while (s->has_pending && (int64_t)result->names.size() < max_reads &&
           (int64_t)result->codes.size() < max_bases) {
      if (s->pending.empty() || s->pending[0] != '@') {
        s->has_pending = false;  // malformed trailer: stop, as the
        break;                   // whole-file reader's loop does
      }
      if (!s->reader->getline(&seq)) {
        s->has_pending = false;
        break;
      }
      s->reader->getline(&plus);
      s->reader->getline(&quals);
      result->names.push_back(first_token(s->pending, 1));
      append_encoded(seq, &result->codes);
      result->offsets.push_back((int64_t)result->codes.size());
      if (!s->reader->getline(&s->pending)) s->has_pending = false;
    }
  } else if (s->format == 2) {
    while (s->has_pending && (int64_t)result->names.size() < max_reads &&
           (int64_t)result->codes.size() < max_bases) {
      std::string name = s->pending;
      for (;;) {
        bool more = s->reader->getline(&line);
        if (!more || (!line.empty() && line[0] == '>')) {
          result->names.push_back(name);
          result->offsets.push_back((int64_t)result->codes.size());
          if (!more) {
            s->has_pending = false;
          } else {
            s->pending = first_token(line, 1);
          }
          break;
        }
        append_encoded(line, &result->codes);
      }
    }
  }
  if (result->names.empty()) {
    delete result;
    return nullptr;
  }
  return result;
}

void svt_stream_close(void* handle) {
  auto* s = static_cast<Stream*>(handle);
  if (s == nullptr) return;
  delete s->reader;
  if (s->file != nullptr) gzclose(s->file);
  delete s;
}

// ---------------------------------------------------------------------------
// Minimizer extraction (the host-side seeding hot loop).
//
// Canonical k-mer minimizers with murmur3-fmix32 hashing, identical to the
// numpy implementation in svjedi_tpu/align/minimizer.py (same constants,
// same leftmost-argmin-per-window selection via a monotonic deque), so the
// native and fallback paths produce the same anchors.
// ---------------------------------------------------------------------------

namespace {

struct MinimizerResult {
  std::vector<int32_t> read_id;
  std::vector<int32_t> pos;     // local to the read
  std::vector<uint32_t> hash;
  std::vector<int8_t> strand;
};

inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

constexpr uint32_t kInvalid = 0xFFFFFFFFu;

}  // namespace

namespace {

// Per-thread scratch for scan_minimizers (avoids per-read allocation when
// the chainer scans one read at a time).
struct ScanScratch {
  std::vector<uint64_t> keys;
  std::vector<uint64_t> sufmin;
};

// Scans reads [r0, r1) appending minimizers to *result. When bitmap is
// non-null, only hashes whose bit (hash masked to bitmap_bits) is set are
// emitted — the caller sets bits for every panel-index hash, so ~99% of
// read minimizers (which never hit the panel) are dropped here instead of
// surviving into the numpy seeding stage. False positives are resolved by
// the exact hash lookup downstream.
//
// Window minima use the branchless two-pass block trick instead of a
// monotonic deque: pack each k-mer as (hash << 32 | local_pos << 1 | strand)
// so an unsigned min is a leftmost-argmin (positions are unique), compute
// per-w-block suffix minima backward and a running prefix minimum forward,
// and every window's min is min(sufmin[s], premin[s + w - 1]). Same
// emission set and order as the numpy reference in align/minimizer.py
// (leftmost argmin per window, consecutive-duplicate dedupe), ~3x the
// deque's throughput on long reads (predictable straight-line loops).
void scan_minimizers(const int8_t* codes, const int64_t* offsets, int64_t r0,
                     int64_t r1, int32_t k, int32_t w, const uint8_t* bitmap,
                     uint32_t bitmap_mask, MinimizerResult* result,
                     ScanScratch* scratch = nullptr) {
  const uint32_t mask = (1u << (2 * k)) - 1;
  const int shift = 2 * (k - 1);
  ScanScratch local;
  ScanScratch& sc = scratch ? *scratch : local;

  for (int64_t r = r0; r < r1; ++r) {
    const int64_t lo = offsets[r], hi = offsets[r + 1];
    const int64_t n_kmers = hi - lo - k + 1;
    if (n_kmers <= 0) continue;
    // Effective window: a read with fewer than w k-mers gets one window
    // over all of them (matches the deque's n_kmers < w special case and
    // the numpy path's `if len(hashes) < w: w = len(hashes)`).
    const int64_t we = std::min<int64_t>(w, n_kmers);
    if ((int64_t)sc.keys.size() < n_kmers) {
      sc.keys.resize(n_kmers);
      sc.sufmin.resize(n_kmers);
    }
    uint64_t* keys = sc.keys.data();
    uint64_t* suf = sc.sufmin.data();

    // Pass 1 — rolling k-mer keys. Invalid (N-containing / palindromic)
    // k-mers carry the sentinel hash and sort after every real hash; a
    // real fmix32 output colliding with the sentinel stays invalid,
    // matching the numpy path's post-hoc `hash != INVALID` filter.
    uint32_t fwd = 0, rc = 0;
    int run = 0;  // consecutive non-N bases ending at i
    for (int64_t i = lo; i < hi; ++i) {
      const int8_t c = codes[i];
      if (c < 4) {
        fwd = ((fwd << 2) | (uint32_t)c) & mask;
        rc = (rc >> 2) | ((uint32_t)(3 - c) << shift);
        ++run;
      } else {
        fwd = rc = 0;
        run = 0;
      }
      const int64_t ks = i - k + 1;
      if (ks < lo) continue;
      const uint64_t posbits = (uint64_t)(uint32_t)(ks - lo) << 1;
      uint64_t key = ((uint64_t)kInvalid << 32) | posbits;
      if (run >= k && fwd != rc) {
        const uint64_t s = rc < fwd ? 1 : 0;
        const uint32_t h = fmix32(s ? rc : fwd);
        key = ((uint64_t)h << 32) | posbits | s;
      }
      keys[ks - lo] = key;
    }

    // Pass 2 — suffix minima within we-aligned blocks.
    for (int64_t bstart = ((n_kmers - 1) / we) * we; bstart >= 0;
         bstart -= we) {
      const int64_t bend = std::min<int64_t>(bstart + we, n_kmers);
      uint64_t m = keys[bend - 1];
      suf[bend - 1] = m;
      for (int64_t i = bend - 2; i >= bstart; --i) {
        m = std::min(m, keys[i]);
        suf[i] = m;
      }
    }

    // Pass 3 — forward prefix minima + per-window emission. The leftmost
    // argmin position is non-decreasing over sliding windows, so a
    // last-emitted check dedupes exactly and output stays position-sorted.
    const int64_t n_win = n_kmers - we + 1;
    uint64_t pre = ~0ull;
    int64_t last_emitted = -1;
    for (int64_t s = 0; s < n_win; ++s) {
      const int64_t e = s + we - 1;
      pre = (e % we == 0) ? keys[e] : std::min(pre, keys[e]);
      const uint64_t m = std::min(pre, suf[s]);
      const uint32_t h = (uint32_t)(m >> 32);
      if (h == kInvalid) continue;
      const int64_t kpos = (int64_t)(((uint32_t)m) >> 1);
      if (kpos == last_emitted) continue;
      last_emitted = kpos;
      if (bitmap != nullptr) {
        const uint32_t b = h & bitmap_mask;
        if (((bitmap[b >> 3] >> (b & 7)) & 1) == 0) continue;
      }
      result->read_id.push_back((int32_t)r);
      result->pos.push_back((int32_t)kpos);
      result->hash.push_back(h);
      result->strand.push_back((int8_t)(m & 1));
    }
  }
}

}  // namespace

// Returns an opaque MinimizerResult* for the concatenated read set.
void* svt_minimizers(const int8_t* codes, int64_t n_bases,
                     const int64_t* offsets, int64_t n_reads, int32_t k,
                     int32_t w) {
  (void)n_bases;
  auto* result = new MinimizerResult();
  if (k <= 0 || k > 15 || w <= 0) return result;
  scan_minimizers(codes, offsets, 0, n_reads, k, w, nullptr, 0, result);
  return result;
}

// Thread-parallel + bitmap-prefiltered variant. bitmap may be null (no
// filter); bitmap_log2 is the log2 of the bitmap size in BITS. n_threads
// <= 0 picks the hardware concurrency.
void* svt_minimizers2(const int8_t* codes, int64_t n_bases,
                      const int64_t* offsets, int64_t n_reads, int32_t k,
                      int32_t w, const uint8_t* bitmap, int32_t bitmap_log2,
                      int32_t n_threads) {
  (void)n_bases;
  auto* result = new MinimizerResult();
  if (k <= 0 || k > 15 || w <= 0 || n_reads <= 0) return result;
  const uint32_t bitmap_mask =
      bitmap ? ((bitmap_log2 >= 32) ? 0xFFFFFFFFu
                                    : ((1u << bitmap_log2) - 1))
             : 0;
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((int64_t)T > n_reads) T = (int)n_reads;
  if (T == 1) {
    scan_minimizers(codes, offsets, 0, n_reads, k, w, bitmap, bitmap_mask,
                    result);
    return result;
  }
  // Balance shards by base count, not read count (read lengths vary).
  const int64_t total = offsets[n_reads] - offsets[0];
  std::vector<int64_t> bounds(T + 1, n_reads);
  bounds[0] = 0;
  int64_t r = 0;
  for (int t = 1; t < T; ++t) {
    const int64_t target = offsets[0] + total * t / T;
    while (r < n_reads && offsets[r] < target) ++r;
    bounds[t] = r;
  }
  std::vector<MinimizerResult> parts(T);
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t]() {
      scan_minimizers(codes, offsets, bounds[t], bounds[t + 1], k, w, bitmap,
                      bitmap_mask, &parts[t]);
    });
  }
  for (auto& th : threads) th.join();
  size_t n = 0;
  for (const auto& p : parts) n += p.hash.size();
  result->read_id.reserve(n);
  result->pos.reserve(n);
  result->hash.reserve(n);
  result->strand.reserve(n);
  for (const auto& p : parts) {
    result->read_id.insert(result->read_id.end(), p.read_id.begin(),
                           p.read_id.end());
    result->pos.insert(result->pos.end(), p.pos.begin(), p.pos.end());
    result->hash.insert(result->hash.end(), p.hash.begin(), p.hash.end());
    result->strand.insert(result->strand.end(), p.strand.begin(),
                          p.strand.end());
  }
  return result;
}

// ---------------------------------------------------------------------------
// Full seeding: minimizers -> index lookup -> chaining -> blocks, one call.
//
// Replicates svjedi_tpu/align/seed.py:seed_candidates exactly: anchors are
// grouped by (read, path, strand) and sorted by (rpos, diag); greedy
// chaining joins each anchor to the existing chain with the closest last
// diagonal within the drift tolerance (abs + permille * rpos gap, gap <=
// max_gap); the top max_chains chains with >= min_anchors anchors are cut
// into block_rows-row read blocks whose d0 is the median anchor diagonal
// of the block (interpolated where anchor-free); chains with >=
// ext_min_anchors get one extension block per side. Chain ids are
// per-read-local (the Python side globalizes). Threaded over read ranges.
// ---------------------------------------------------------------------------

namespace {

struct SeedResult {
  std::vector<int32_t> read;
  std::vector<int32_t> path;
  std::vector<int8_t> strand;
  std::vector<int32_t> d0;
  std::vector<int32_t> support;
  std::vector<int32_t> chain;  // per-read-local chain id
  std::vector<int32_t> q_lo;
  std::vector<int32_t> q_hi;
  std::vector<int32_t> a_lo;  // chain anchor extent (oriented read coords)
  std::vector<int32_t> a_hi;
  //: head-anchor diagonal per row: with a_lo (the head-anchor rpos) this
  //: keys the chain's CREATION ORDER inside its (read, path, strand)
  //: group — anchors are processed in ascending (rpos, diag), so chains
  //: are created in ascending (head rpos, head diag). The sharded-decoy
  //: union (dist/decoy_shard.py) needs it to re-apply the global
  //: max_chains truncation with the exact stable tie-break.
  std::vector<int32_t> head_diag;
};

// Open-addressing exact-hash table over the index's unique minimizer
// hashes: slot = (hash << 32) | (uniq_idx + 1), 0 = empty, linear probing
// at <= 50% load. Replaces the per-minimizer binary search (log2(U)
// dependent branchy probes) with ~1 cache line; built once per index and
// shared across chunks/threads (read-only after build).
struct HashLookup {
  std::vector<uint64_t> slots;
  uint64_t mask = 0;
};

HashLookup* build_hash_lookup(const uint32_t* uniq_hash, int64_t n_uniq) {
  auto* t = new HashLookup();
  uint64_t cap = 16;
  while (cap < (uint64_t)n_uniq * 2) cap <<= 1;
  t->slots.assign(cap, 0);
  t->mask = cap - 1;
  for (int64_t u = 0; u < n_uniq; ++u) {
    const uint32_t h = uniq_hash[u];
    uint64_t i = h & t->mask;
    while (t->slots[i] != 0) i = (i + 1) & t->mask;
    t->slots[i] = ((uint64_t)h << 32) | (uint64_t)(uint32_t)(u + 1);
  }
  return t;
}

struct SeedIndex {
  const uint32_t* uniq_hash;
  int64_t n_uniq;
  const int64_t* hit_start;
  const int32_t* hit_path;
  const int32_t* hit_pos;
  const int8_t* hit_strand;
  const HashLookup* lut = nullptr;  // optional exact-lookup accelerator
  //: optional interleaved hit stream: (path << 33) | (strand << 32) | pos.
  //: The expand phase walks hit lists at random offsets; three parallel
  //: arrays cost three cache-miss streams per list, one packed array costs
  //: one — at genome scale expand is the seed bottleneck and is
  //: MEMORY-bound, not compute-bound (PERF.md "anchor-volume-bound").
  const uint64_t* hit_packed = nullptr;
};

struct ChainParams {
  int32_t min_anchors;
  int32_t max_chains;
  int32_t max_gap;
  int32_t drift_abs;
  int32_t drift_permille;
  int32_t block_rows;
  int32_t ext_min_anchors;
};

struct Anchor {
  int64_t key;  // (path << 1 | strand) — group within the read
  int64_t rpos;
  int64_t diag;
};

// Anchor membership is a flat singly-linked list through the scratch's
// ``nxt`` array (group-local anchor indices): zero per-chain heap
// allocation, and iteration order = append order = ascending rpos.
struct ChainHyp {
  int64_t last_rpos, last_diag;
  int32_t head, tail, count;
};

// Phase profiling for the chaining hot path (SVJT_CHAIN_PROF=1):
// cross-thread nanosecond accumulators, printed by svt_chain5.
struct ChainProf {
  std::atomic<int64_t> expand_ns{0}, sort_ns{0}, chain_ns{0},
      blocks_ns{0}, anchors{0}, reads{0};
  //: emission-bitmask walk + k-mer hash recompute (chain_bits_range
  //: only — the phase BEFORE chain_one_read's own accounting).
  std::atomic<int64_t> scan_ns{0}, emitted{0};
};
inline ChainProf& chain_prof() {
  static ChainProf p;
  return p;
}
inline bool chain_prof_on() {
  static const bool on = std::getenv("SVJT_CHAIN_PROF") != nullptr;
  return on;
}
inline int64_t prof_now() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Print + reset the accumulators. Called at the end of EVERY svt_chain*
// entry point (not just svt_chain5): the counters are global, so a
// host-scan fallback path running svt_chain3/4 must drain them itself or
// its timings would silently pollute the next svt_chain5 report.
inline void chain_prof_report(const char* entry) {
  if (!chain_prof_on()) return;
  ChainProf& p = chain_prof();
  int64_t reads = p.reads.exchange(0);
  int64_t anchors = p.anchors.exchange(0);
  int64_t emitted = p.emitted.exchange(0);
  double scan = p.scan_ns.exchange(0) / 1e9;
  double expand = p.expand_ns.exchange(0) / 1e9;
  double sort = p.sort_ns.exchange(0) / 1e9;
  double chain = p.chain_ns.exchange(0) / 1e9;
  double blocks = p.blocks_ns.exchange(0) / 1e9;
  if (reads == 0 && anchors == 0 && emitted == 0) return;
  fprintf(stderr,
          "[chain_prof] %s reads=%lld emitted=%lld anchors=%lld "
          "scan=%.3fs expand=%.3fs sort=%.3fs chain=%.3fs blocks=%.3fs "
          "(cpu-s, summed over threads)\n",
          entry, (long long)reads, (long long)emitted, (long long)anchors,
          scan, expand, sort, chain, blocks);
}

// Reusable per-thread scratch for chain_one_read (avoids reallocation).
// Anchors are grouped by (path, strand) key through an epoch-stamped
// open-addressing map DURING expansion, and each anchor packs
// (rpos << 32 | diag + 2^31) into one uint64 so the per-group sort
// compares 8-byte scalars — ascending uint64 == ascending (rpos, diag),
// exactly the old 3-field comparator restricted to a group.
struct ChainScratch {
  std::vector<uint64_t> tmp_packed;  // emission-order packed anchors
  std::vector<int32_t> tmp_bucket;   // emission-order bucket ids
  std::vector<uint64_t> packed;      // key-major scatter target
  std::vector<int64_t> bkeys;        // bucket -> (path << 1 | strand)
  std::vector<int32_t> bcount;       // bucket count, then scatter cursor
  std::vector<int32_t> bstart;       // bucket subrange start
  std::vector<std::pair<int64_t, int32_t>> border;  // (key, bucket) sorted
  std::vector<int64_t> map_key;      // open addressing key -> bucket
  std::vector<int32_t> map_val;
  std::vector<int32_t> map_epoch;
  int32_t epoch = 0;
  std::vector<ChainHyp> chains;
  std::vector<int32_t> active;
  std::vector<int32_t> nxt;
  std::vector<size_t> kept;
  std::vector<int64_t> d0s;
  std::vector<int64_t> med;
  std::vector<int64_t> umap;  // per-minimizer resolved uniq-hash index
  // Diag-bucketed election (large groups): open-addressed bucket map +
  // append-only entry pool (see chain_one_read).
  struct BEntry {
    int32_t chain, next;
  };
  std::vector<BEntry> bentries;
  std::vector<int32_t> chain_entry;  // chain -> its LIVE entry (-1 dead)
  std::vector<int64_t> bkt_key;
  std::vector<int32_t> bkt_head;
  std::vector<int32_t> bkt_epoch;
  int32_t bkt_cur = 0;
};

// Anchors -> chains -> blocks for ONE read given its minimizers (pos local
// to the read, position-sorted). Factored out of chain_reads so the
// device-scan path (svt_chain4: minimizers computed on the TPU device,
// align/dev_scan.py) shares the exact lookup + chaining semantics.
void chain_one_read(int64_t r, int64_t rlen, const int32_t* mpos,
                    const uint32_t* mhash, const int8_t* mstrand, int64_t nm,
                    int32_t k, const SeedIndex& idx, const ChainParams& cp,
                    SeedResult* out, int32_t panel_path_limit,
                    ChainScratch& cs) {
  std::vector<uint64_t>& tmp_packed = cs.tmp_packed;
  std::vector<int32_t>& tmp_bucket = cs.tmp_bucket;
  std::vector<uint64_t>& packed = cs.packed;
  std::vector<int64_t>& bkeys = cs.bkeys;
  std::vector<int32_t>& bcount = cs.bcount;
  std::vector<int32_t>& bstart = cs.bstart;
  std::vector<ChainHyp>& chains = cs.chains;
  std::vector<int32_t>& active = cs.active;
  std::vector<int32_t>& nxt = cs.nxt;
  std::vector<size_t>& kept = cs.kept;
  std::vector<int64_t>& d0s = cs.d0s;
  std::vector<int64_t>& med = cs.med;
  const bool prof = chain_prof_on();
  int64_t tp0 = prof ? prof_now() : 0;

  tmp_packed.clear();
  tmp_bucket.clear();
  bkeys.clear();
  bcount.clear();
  ++cs.epoch;
  if (cs.map_key.size() < 64) {
    cs.map_key.resize(64);
    cs.map_val.resize(64);
    cs.map_epoch.assign(64, 0);
  }
  // find-or-insert (path<<1|strand) -> dense bucket id; epoch stamping
  // makes per-read reset free, growth rehashes only this read's keys.
  auto bucket_of = [&](int64_t key) -> int32_t {
    if ((bkeys.size() + 1) * 2 > cs.map_key.size()) {
      const size_t ncap = cs.map_key.size() * 2;
      std::vector<int64_t> nk(ncap);
      std::vector<int32_t> nv(ncap);
      std::vector<int32_t> ne(ncap, 0);
      const uint64_t nmask = ncap - 1;
      for (size_t b = 0; b < bkeys.size(); ++b) {
        uint64_t si = ((uint64_t)bkeys[b] * 0x9E3779B97F4A7C15ULL) & nmask;
        while (ne[si] != 0) si = (si + 1) & nmask;
        ne[si] = 1;
        nk[si] = bkeys[b];
        nv[si] = (int32_t)b;
      }
      // stamp inserted slots with the current epoch
      for (size_t si = 0; si < ncap; ++si)
        if (ne[si]) ne[si] = cs.epoch;
      cs.map_key.swap(nk);
      cs.map_val.swap(nv);
      cs.map_epoch.swap(ne);
    }
    const uint64_t mask = cs.map_key.size() - 1;
    uint64_t si = ((uint64_t)key * 0x9E3779B97F4A7C15ULL) & mask;
    while (cs.map_epoch[si] == cs.epoch) {
      if (cs.map_key[si] == key) return cs.map_val[si];
      si = (si + 1) & mask;
    }
    cs.map_epoch[si] = cs.epoch;
    cs.map_key[si] = key;
    cs.map_val[si] = (int32_t)bkeys.size();
    bkeys.push_back(key);
    bcount.push_back(0);
    return (int32_t)(bkeys.size() - 1);
  };
  constexpr int64_t kDiagBias = INT64_C(0x80000000);
  constexpr int64_t kPF = 8;  // software-prefetch lookahead

  // Two-pass expand: pass 1 resolves every minimizer's uniq-hash slot
  // with the NEXT probes prefetched; pass 2 walks the hit lists with the
  // NEXT lists prefetched. The expand phase is memory-latency-bound at
  // genome scale (~250 ns/anchor measured, PERF.md) — the lists live at
  // random offsets in a multi-GB table, so the win is hiding the misses,
  // not saving instructions.
  std::vector<int64_t>& umap = cs.umap;
  umap.resize(nm);
  if (idx.lut != nullptr) {
    const uint64_t mask = idx.lut->mask;
    const uint64_t* slots = idx.lut->slots.data();
    for (int64_t i = 0; i < nm; ++i) {
      if (i + kPF < nm)
        __builtin_prefetch(&slots[mhash[i + kPF] & mask]);
      const uint32_t h = mhash[i];
      int64_t u = -1;
      uint64_t si = h & mask;
      for (uint64_t slot; (slot = slots[si]) != 0; si = (si + 1) & mask) {
        if ((uint32_t)(slot >> 32) == h) {
          u = (int64_t)(uint32_t)slot - 1;
          break;
        }
      }
      umap[i] = u;
      if (u >= 0) __builtin_prefetch(&idx.hit_start[u]);
    }
  } else {
    for (int64_t i = 0; i < nm; ++i) {
      const uint32_t h = mhash[i];
      const uint32_t* lo =
          std::lower_bound(idx.uniq_hash, idx.uniq_hash + idx.n_uniq, h);
      umap[i] = (lo == idx.uniq_hash + idx.n_uniq || *lo != h)
                    ? -1
                    : lo - idx.uniq_hash;
    }
  }
  for (int64_t i = 0; i < nm; ++i) {
    const int64_t u = umap[i];
    if (u < 0) continue;
    // Prefetch the next resolved minimizer's hit range.
    for (int64_t p = i + 1, seen = 0; p < nm && seen < 1; ++p) {
      if (umap[p] >= 0) {
        const int64_t js = idx.hit_start[umap[p]];
        if (idx.hit_packed != nullptr) {
          __builtin_prefetch(&idx.hit_packed[js]);
        } else {
          __builtin_prefetch(&idx.hit_path[js]);
          __builtin_prefetch(&idx.hit_pos[js]);
          __builtin_prefetch(&idx.hit_strand[js]);
        }
        ++seen;
      }
    }
    const int64_t j_lo = idx.hit_start[u], j_hi = idx.hit_start[u + 1];
    const int64_t rp_f = (int64_t)mpos[i];
    const int64_t rp_r = rlen - k - (int64_t)mpos[i];
    const int8_t ms = mstrand[i];
    if (idx.hit_packed != nullptr) {
      for (int64_t j = j_lo; j < j_hi; ++j) {
        const uint64_t e = idx.hit_packed[j];
        const int8_t strand = (int8_t)(ms ^ (int8_t)((e >> 32) & 1));
        const int64_t rpos_eff = strand == 0 ? rp_f : rp_r;
        const int64_t diag = (int64_t)(uint32_t)e - rpos_eff;
        const int32_t b = bucket_of(((int64_t)(e >> 33) << 1) | strand);
        tmp_bucket.push_back(b);
        tmp_packed.push_back(((uint64_t)rpos_eff << 32) |
                             (uint32_t)(diag + kDiagBias));
        ++bcount[b];
      }
    } else {
      for (int64_t j = j_lo; j < j_hi; ++j) {
        const int8_t strand = (int8_t)(ms ^ idx.hit_strand[j]);
        const int64_t rpos_eff = strand == 0 ? rp_f : rp_r;
        const int64_t diag = idx.hit_pos[j] - rpos_eff;
        const int32_t b =
            bucket_of(((int64_t)idx.hit_path[j] << 1) | strand);
        tmp_bucket.push_back(b);
        tmp_packed.push_back(((uint64_t)rpos_eff << 32) |
                             (uint32_t)(diag + kDiagBias));
        ++bcount[b];
      }
    }
  }
  if (tmp_packed.empty()) return;
  // Merged panel+decoy seeding: a read with no panel anchor can never
  // contribute a count, and decoy chains are consulted only for reads
  // with panel chains — skip the whole read before the sort/chain work.
  if (panel_path_limit > 0) {
    bool has_panel = false;
    for (const int64_t key : bkeys) {
      if ((key >> 1) < panel_path_limit) {
        has_panel = true;
        break;
      }
    }
    if (!has_panel) return;
  }
  int64_t tp1 = 0;
  if (prof) {
    tp1 = prof_now();
    chain_prof().expand_ns += tp1 - tp0;
    chain_prof().anchors += (int64_t)tmp_packed.size();
    chain_prof().reads += 1;
  }
  // Stable scatter into key-major layout, groups in ascending-key order
  // (the old global sort's primary key), then an 8-byte sort per group
  // gives ascending (rpos, diag) — identical total order to the old
  // 3-field comparator.
  std::vector<std::pair<int64_t, int32_t>>& border = cs.border;
  border.clear();
  for (size_t b = 0; b < bkeys.size(); ++b)
    border.emplace_back(bkeys[b], (int32_t)b);
  std::sort(border.begin(), border.end());
  bstart.resize(bkeys.size());
  int32_t cum = 0;
  for (const auto& kb : border) {
    bstart[kb.second] = cum;
    cum += bcount[kb.second];
  }
  packed.resize(tmp_packed.size());
  // bcount becomes the scatter cursor; subrange of bucket b ends where
  // the cursor stops.
  for (size_t b = 0; b < bkeys.size(); ++b) bcount[b] = bstart[b];
  for (size_t a = 0; a < tmp_packed.size(); ++a)
    packed[bcount[tmp_bucket[a]]++] = tmp_packed[a];
  for (const auto& kb : border)
    std::sort(packed.begin() + bstart[kb.second],
              packed.begin() + bcount[kb.second]);
  if (prof) {
    const int64_t tp2 = prof_now();
    chain_prof().sort_ns += tp2 - tp1;
    tp1 = tp2;
  }

  int32_t chain_counter = 0;  // per-read-local
  for (const auto& kb : border) {
    const int64_t key = kb.first;
    const size_t s = (size_t)bstart[kb.second];
    const size_t g_end = (size_t)bcount[kb.second];
    const auto rpos_at = [&](size_t x) -> int64_t {
      return (int64_t)(packed[x] >> 32);
    };
    const auto diag_at = [&](size_t x) -> int64_t {
      return (int64_t)(uint32_t)packed[x] - kDiagBias;
    };

    // ---- greedy chaining (== seed.py _chain_group) ----
    // rpos is non-decreasing across the group, so a chain whose gap
    // exceeds max_gap is dead for every later anchor too: keep a
    // compacted active list (creation order preserved — the strict
    // dd < best_dd tie-break keeps electing the earliest-created chain,
    // identical to scanning the full list).
    //
    // Large groups (a read's minimizers hitting MANY loci of one decoy
    // chromosome — the genome-scale case) switch to a DIAG-BUCKETED
    // election: the drift tolerance caps at drift_abs +
    // drift_permille*max_gap/1000 (= 678 at defaults) < the 1024-wide
    // buckets, so only the anchor's own and two neighboring buckets can
    // hold an eligible chain. Electing min (dd, chain id) with strict
    // comparison is EXACTLY the linear scan's result: the scan visits
    // chains in creation order with a strict dd < best_dd test, so ties
    // resolve to the smallest chain id either way. Chains live in
    // append-only entry nodes (a chain's current entry is
    // chain_entry[j]; older entries turn stale when it moves bucket and
    // unlink lazily), so moving a chain never corrupts a list.
    constexpr int kDiagShift = 10;  // 1024 > max drift tolerance 678
    constexpr size_t kBucketSwitch = 12;
    constexpr int64_t kEntryDead = -2;
    chains.clear();
    active.clear();
    nxt.assign(g_end - s, -1);
    std::vector<ChainScratch::BEntry>& bentries = cs.bentries;
    std::vector<int32_t>& chain_entry = cs.chain_entry;
    bool bucketed = false;
    // The +-1-bucket scan is only exhaustive while the worst-case drift
    // tolerance fits inside one bucket; with exotic runtime params fall
    // back to the always-correct linear scan.
    const int64_t tol_cap =
        cp.drift_abs + ((int64_t)cp.drift_permille * cp.max_gap) / 1000;
    const bool bucket_ok = tol_cap < ((int64_t)1 << kDiagShift);
    if (cs.bkt_key.size() < 64) {
      cs.bkt_key.resize(64);
      cs.bkt_head.resize(64);
      cs.bkt_epoch.assign(64, 0);
    }
    // find-or-create a bucket slot for key bb (epoch-stamped map).
    auto bkt_slot = [&](int64_t bb, bool create) -> int32_t {
      const uint64_t mask0 = cs.bkt_key.size() - 1;
      uint64_t si = ((uint64_t)bb * 0x9E3779B97F4A7C15ULL) & mask0;
      while (cs.bkt_epoch[si] == cs.bkt_cur) {
        if (cs.bkt_key[si] == bb) return (int32_t)si;
        si = (si + 1) & mask0;
      }
      if (!create) return -1;
      cs.bkt_epoch[si] = cs.bkt_cur;
      cs.bkt_key[si] = bb;
      cs.bkt_head[si] = -1;
      return (int32_t)si;
    };
    auto bkt_grow_if_needed = [&](size_t live) {
      if ((live + 1) * 2 <= cs.bkt_key.size()) return;
      // Rehash by re-inserting every LIVE chain entry (stale entries are
      // dropped for free).
      const size_t ncap = cs.bkt_key.size() * 2;
      std::vector<int64_t> nk(ncap);
      std::vector<int32_t> nh(ncap, -1);
      std::vector<int32_t> ne(ncap, 0);
      const uint64_t nmask = ncap - 1;
      for (size_t j = 0; j < chains.size(); ++j) {
        if (chain_entry[j] < 0) continue;
        const int64_t bb = (chains[j].last_diag + kDiagBias) >> kDiagShift;
        uint64_t si = ((uint64_t)bb * 0x9E3779B97F4A7C15ULL) & nmask;
        while (ne[si] != 0 && nk[si] != bb) si = (si + 1) & nmask;
        if (ne[si] == 0) {
          ne[si] = 1;
          nk[si] = bb;
          nh[si] = -1;
        }
        const int32_t e = (int32_t)bentries.size();
        bentries.push_back({(int32_t)j, nh[si]});
        nh[si] = e;
        chain_entry[j] = e;
      }
      for (size_t si = 0; si < ncap; ++si) ne[si] = ne[si] ? cs.bkt_cur : 0;
      cs.bkt_key.swap(nk);
      cs.bkt_head.swap(nh);
      cs.bkt_epoch.swap(ne);
    };
    auto bkt_insert = [&](int32_t j) {
      bkt_grow_if_needed(chains.size());
      const int64_t bb = (chains[j].last_diag + kDiagBias) >> kDiagShift;
      const int32_t si = bkt_slot(bb, /*create=*/true);
      const int32_t e = (int32_t)bentries.size();
      bentries.push_back({j, cs.bkt_head[si]});
      cs.bkt_head[si] = e;
      chain_entry[j] = e;
    };
    for (size_t a = s; a < g_end; ++a) {
      const int64_t rp = rpos_at(a), dg = diag_at(a);
      int best_j = -1;
      int64_t best_dd = 0;
      if (!bucketed) {
        size_t na = 0;
        for (size_t ji = 0; ji < active.size(); ++ji) {
          const int32_t j = active[ji];
          const int64_t gap = rp - chains[j].last_rpos;
          if (gap > cp.max_gap) continue;  // retired for good
          active[na++] = j;
          const int64_t dd = std::llabs(dg - chains[j].last_diag);
          if (dd >
              cp.drift_abs + ((int64_t)cp.drift_permille * gap) / 1000)
            continue;
          if (best_j < 0 || dd < best_dd) {
            best_dd = dd;
            best_j = j;
          }
        }
        active.resize(na);
        if (bucket_ok && active.size() > kBucketSwitch) {
          // Migrate the live chains into the bucket structure.
          bucketed = true;
          ++cs.bkt_cur;
          bentries.clear();
          chain_entry.assign(chains.size(), -1);
          for (const int32_t j : active) bkt_insert(j);
        }
      } else {
        const int64_t bb = (dg + kDiagBias) >> kDiagShift;
        for (int64_t b2 = bb - 1; b2 <= bb + 1; ++b2) {
          const int32_t si = bkt_slot(b2, /*create=*/false);
          if (si < 0) continue;
          int32_t* pj = &cs.bkt_head[si];
          while (*pj >= 0) {
            const ChainScratch::BEntry ent = bentries[*pj];
            const int32_t j = ent.chain;
            if (chain_entry[j] != *pj) {  // stale or dead: unlink
              *pj = ent.next;
              continue;
            }
            const int64_t gap = rp - chains[j].last_rpos;
            if (gap > cp.max_gap) {  // retired for good
              chain_entry[j] = (int32_t)kEntryDead;
              *pj = ent.next;
              continue;
            }
            const int64_t dd = std::llabs(dg - chains[j].last_diag);
            if (dd <= cp.drift_abs +
                          ((int64_t)cp.drift_permille * gap) / 1000 &&
                (best_j < 0 || dd < best_dd ||
                 (dd == best_dd && j < best_j))) {
              best_dd = dd;
              best_j = j;
            }
            pj = &bentries[*pj].next;
          }
        }
      }
      const int32_t al = (int32_t)(a - s);
      if (best_j >= 0) {
        ChainHyp& c = chains[best_j];
        const int64_t old_bb = (c.last_diag + kDiagBias) >> kDiagShift;
        c.last_rpos = rp;
        c.last_diag = dg;
        nxt[c.tail] = al;
        c.tail = al;
        ++c.count;
        if (bucketed) {
          const int64_t new_bb = (dg + kDiagBias) >> kDiagShift;
          if (new_bb != old_bb) bkt_insert(best_j);  // old entry -> stale
        }
      } else {
        const int32_t j = (int32_t)chains.size();
        chains.push_back({rp, dg, al, al, 1});
        if (bucketed) {
          chain_entry.push_back(-1);
          bkt_insert(j);
        } else {
          active.push_back(j);
        }
      }
    }

    // ---- keep top max_chains by count (stable: creation order) ----
    kept.clear();
    for (size_t j = 0; j < chains.size(); ++j)
      if (chains[j].count >= cp.min_anchors) kept.push_back(j);
    std::stable_sort(kept.begin(), kept.end(), [&](size_t a, size_t b) {
      return chains[a].count > chains[b].count;
    });
    if ((int32_t)kept.size() > cp.max_chains) kept.resize(cp.max_chains);
    if (prof) {
      const int64_t tg = prof_now();
      chain_prof().chain_ns += tg - tp1;
      tp1 = tg;
    }

    // ---- blocks per chain (== seed.py _blocks_for_chain) ----
    const int64_t R = cp.block_rows;
    const int64_t kMissing = INT64_MIN;
    for (size_t kj : kept) {
      const ChainHyp& ch = chains[kj];
      const int64_t q_first = rpos_at(s + ch.head);
      const int64_t q_last = rpos_at(s + ch.tail);
      const int64_t b_first = q_first / R, b_last = q_last / R;
      const int64_t b_max = std::max<int64_t>(0, (rlen - 1) / R);
      int64_t b0 = b_first, b1 = b_last;
      if (ch.count >= cp.ext_min_anchors) {
        b0 = std::max<int64_t>(0, b0 - 1);
        b1 = std::min(b_max, b1 + 1);
      }
      const int64_t n_blocks = b1 - b0 + 1;
      d0s.assign(n_blocks, kMissing);
      // One walk down the chain: rpos is non-decreasing along it (the
      // group is rpos-sorted and appended in order), so each block's
      // anchors form a contiguous run.
      med.clear();
      int64_t cur_b = b_first;
      for (int32_t ai = ch.head; ai >= 0; ai = nxt[ai]) {
        const int64_t bi = rpos_at(s + ai) / R;
        if (bi != cur_b) {
          if (!med.empty()) {
            std::sort(med.begin(), med.end());
            d0s[cur_b - b0] = med[(med.size() - 1) / 2];
            med.clear();
          }
          cur_b = bi;
        }
        med.push_back(diag_at(s + ai));
      }
      if (!med.empty()) {
        std::sort(med.begin(), med.end());
        d0s[cur_b - b0] = med[(med.size() - 1) / 2];
      }
      for (int64_t bi = 0; bi < n_blocks; ++bi) {
        if (d0s[bi] != kMissing) continue;
        int64_t left = -1, right = -1;
        for (int64_t j = bi - 1; j >= 0; --j)
          if (d0s[j] != kMissing) { left = j; break; }
        for (int64_t j = bi + 1; j < n_blocks; ++j)
          if (d0s[j] != kMissing) { right = j; break; }
        if (left >= 0 && right >= 0) {
          const double v =
              (double)d0s[left] +
              (double)(d0s[right] - d0s[left]) * (double)(bi - left) /
                  (double)(right - left);
          d0s[bi] = (int64_t)std::llround(v);
        } else if (left >= 0) {
          d0s[bi] = d0s[left];
        } else {
          d0s[bi] = d0s[right];
        }
      }
      const int32_t hd = (int32_t)diag_at(s + ch.head);
      for (int64_t bi = 0; bi < n_blocks; ++bi) {
        const int64_t b = b0 + bi;
        out->read.push_back((int32_t)r);
        out->path.push_back((int32_t)(key >> 1));
        out->strand.push_back((int8_t)(key & 1));
        out->d0.push_back((int32_t)d0s[bi]);
        out->support.push_back(ch.count);
        out->chain.push_back(chain_counter);
        out->q_lo.push_back((int32_t)(b * R));
        out->q_hi.push_back((int32_t)std::min((b + 1) * R, rlen));
        out->a_lo.push_back((int32_t)q_first);
        out->a_hi.push_back((int32_t)std::min(q_last + k, rlen));
        out->head_diag.push_back(hd);
      }
      ++chain_counter;
    }
    if (prof) {
      const int64_t tg = prof_now();
      chain_prof().blocks_ns += tg - tp1;
      tp1 = tg;
    }
  }
}


void chain_reads(const int8_t* codes, const int64_t* offsets, int64_t r0,
                 int64_t r1, int32_t k, int32_t w, const uint8_t* bitmap,
                 uint32_t bitmap_mask, const SeedIndex& idx,
                 const ChainParams& cp, SeedResult* out,
                 int32_t panel_path_limit = 0) {
  MinimizerResult mins;
  ScanScratch scratch;
  ChainScratch cs;
  for (int64_t r = r0; r < r1; ++r) {
    mins.read_id.clear();
    mins.pos.clear();
    mins.hash.clear();
    mins.strand.clear();
    scan_minimizers(codes, offsets, r, r + 1, k, w, bitmap, bitmap_mask,
                    &mins, &scratch);
    if (mins.hash.empty()) continue;
    chain_one_read(r, offsets[r + 1] - offsets[r], mins.pos.data(),
                   mins.hash.data(), mins.strand.data(),
                   (int64_t)mins.hash.size(), k, idx, cp, out,
                   panel_path_limit, cs);
  }
}

// Lookup + chaining from the device scan's emission BITMASK (bit p set =
// global k-mer start p is a minimizer of its read; LSB-first bytes, the
// align/dev_scan.py pack order). Hash/strand are recomputed here from the
// codes (direct 2-bit packing — identical to the rolling formulation),
// the panel bitmap + exact lookup applied, then chain_one_read. Reads
// with fewer than w k-mers (shrunken effective window, not expressible in
// the device's flat formulation) fall back to the native per-read scan.
void chain_bits_range(const int8_t* codes, const int64_t* offsets,
                      int64_t r0, int64_t r1, int32_t k, int32_t w,
                      const uint8_t* emit_bits, const uint8_t* bitmap,
                      uint32_t bitmap_mask, const SeedIndex& idx,
                      const ChainParams& cp, SeedResult* out,
                      int32_t panel_path_limit) {
  MinimizerResult mins;
  ScanScratch scratch;
  ChainScratch cs;
  const bool prof = chain_prof_on();
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t lo = offsets[r], hi = offsets[r + 1];
    const int64_t n_kmers = hi - lo - k + 1;
    if (n_kmers <= 0) continue;
    const int64_t ts0 = prof ? prof_now() : 0;
    mins.read_id.clear();
    mins.pos.clear();
    mins.hash.clear();
    mins.strand.clear();
    if (n_kmers < w) {
      scan_minimizers(codes, offsets, r, r + 1, k, w, bitmap, bitmap_mask,
                      &mins, &scratch);
    } else {
      const int64_t pend = lo + n_kmers;
      for (int64_t by = lo >> 3; by < ((pend + 7) >> 3); ++by) {
        uint8_t v = emit_bits[by];
        while (v) {
          const int bit = __builtin_ctz(v);
          v = (uint8_t)(v & (v - 1));
          const int64_t p = (by << 3) + bit;
          if (p < lo || p >= pend) continue;
          uint32_t fwd = 0, rc = 0;
          bool ok = true;
          for (int32_t j = 0; j < k; ++j) {
            const int8_t cc = codes[p + j];
            if (cc >= 4 || cc < 0) {  // defensive: device excludes N
              ok = false;
              break;
            }
            fwd = (fwd << 2) | (uint32_t)cc;
            rc |= (uint32_t)(3 - cc) << (2 * j);
          }
          if (!ok || fwd == rc) continue;
          const bool s = rc < fwd;
          const uint32_t h = fmix32(s ? rc : fwd);
          if (bitmap != nullptr) {
            const uint32_t b = h & bitmap_mask;
            if (((bitmap[b >> 3] >> (b & 7)) & 1) == 0) continue;
          }
          mins.pos.push_back((int32_t)(p - lo));
          mins.hash.push_back(h);
          mins.strand.push_back((int8_t)(s ? 1 : 0));
        }
      }
    }
    if (prof) {
      chain_prof().scan_ns += prof_now() - ts0;
      chain_prof().emitted += (int64_t)mins.hash.size();
    }
    if (mins.hash.empty()) continue;
    chain_one_read(r, hi - lo, mins.pos.data(), mins.hash.data(),
                   mins.strand.data(), (int64_t)mins.hash.size(), k, idx,
                   cp, out, panel_path_limit, cs);
  }
}

// Lookup + chaining over a PREcomputed minimizer list (read-major,
// position-sorted within each read — the device scan's emission order).
void chain_mins_range(const int64_t* offsets, const int32_t* m_read,
                      const int32_t* m_pos, const uint32_t* m_hash,
                      const int8_t* m_strand, int64_t i0, int64_t i1,
                      int32_t k, const SeedIndex& idx, const ChainParams& cp,
                      SeedResult* out, int32_t panel_path_limit) {
  ChainScratch cs;
  int64_t i = i0;
  while (i < i1) {
    const int32_t r = m_read[i];
    int64_t j = i;
    while (j < i1 && m_read[j] == r) ++j;
    chain_one_read(r, offsets[r + 1] - offsets[r], m_pos + i, m_hash + i,
                   m_strand + i, j - i, k, idx, cp, out, panel_path_limit,
                   cs);
    i = j;
  }
}

}  // namespace

// Prebuilt exact-lookup table over an index's unique hashes; pass the
// handle to svt_chain3 (build once per index, reuse across chunks).
void* svt_lookup_build(const uint32_t* uniq_hash, int64_t n_uniq) {
  if (n_uniq < 0) return nullptr;
  return build_hash_lookup(uniq_hash, n_uniq);
}

void svt_lookup_free(void* handle) {
  delete static_cast<HashLookup*>(handle);
}

void* svt_chain3(const int8_t* codes, int64_t n_bases,
                 const int64_t* offsets, int64_t n_reads, int32_t k,
                 int32_t w, const uint8_t* bitmap, int32_t bitmap_log2,
                 const uint32_t* uniq_hash, int64_t n_uniq,
                 const int64_t* hit_start, const int32_t* hit_path,
                 const int32_t* hit_pos, const int8_t* hit_strand,
                 int32_t min_anchors, int32_t max_chains, int32_t max_gap,
                 int32_t drift_abs, int32_t drift_permille,
                 int32_t block_rows, int32_t ext_min_anchors,
                 int32_t panel_path_limit, int32_t n_threads,
                 void* lookup) {
  (void)n_bases;
  auto* result = new SeedResult();
  if (k <= 0 || k > 15 || w <= 0 || n_reads <= 0 || block_rows <= 0)
    return result;
  const uint32_t bitmap_mask =
      bitmap ? ((bitmap_log2 >= 32) ? 0xFFFFFFFFu
                                    : ((1u << bitmap_log2) - 1))
             : 0;
  SeedIndex idx{uniq_hash,  n_uniq,     hit_start,
                hit_path,   hit_pos,    hit_strand,
                static_cast<const HashLookup*>(lookup)};
  ChainParams cp{min_anchors, max_chains,  max_gap,       drift_abs,
                 drift_permille, block_rows, ext_min_anchors};
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((int64_t)T > n_reads) T = (int)n_reads;
  if (T == 1) {
    chain_reads(codes, offsets, 0, n_reads, k, w, bitmap, bitmap_mask, idx,
                cp, result, panel_path_limit);
    chain_prof_report("chain3");
    return result;
  }
  const int64_t total = offsets[n_reads] - offsets[0];
  std::vector<int64_t> bounds(T + 1, n_reads);
  bounds[0] = 0;
  int64_t r = 0;
  for (int t = 1; t < T; ++t) {
    const int64_t target = offsets[0] + total * t / T;
    while (r < n_reads && offsets[r] < target) ++r;
    bounds[t] = r;
  }
  std::vector<SeedResult> parts(T);
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t]() {
      chain_reads(codes, offsets, bounds[t], bounds[t + 1], k, w, bitmap,
                  bitmap_mask, idx, cp, &parts[t], panel_path_limit);
    });
  }
  for (auto& th : threads) th.join();
  chain_prof_report("chain3");
  size_t n = 0;
  for (const auto& p : parts) n += p.read.size();
  result->read.reserve(n);
  result->path.reserve(n);
  result->strand.reserve(n);
  result->d0.reserve(n);
  result->support.reserve(n);
  result->chain.reserve(n);
  result->q_lo.reserve(n);
  result->q_hi.reserve(n);
  result->a_lo.reserve(n);
  result->a_hi.reserve(n);
  for (const auto& p : parts) {
    result->read.insert(result->read.end(), p.read.begin(), p.read.end());
    result->path.insert(result->path.end(), p.path.begin(), p.path.end());
    result->strand.insert(result->strand.end(), p.strand.begin(),
                          p.strand.end());
    result->d0.insert(result->d0.end(), p.d0.begin(), p.d0.end());
    result->support.insert(result->support.end(), p.support.begin(),
                           p.support.end());
    result->chain.insert(result->chain.end(), p.chain.begin(),
                         p.chain.end());
    result->q_lo.insert(result->q_lo.end(), p.q_lo.begin(), p.q_lo.end());
    result->q_hi.insert(result->q_hi.end(), p.q_hi.begin(), p.q_hi.end());
    result->a_lo.insert(result->a_lo.end(), p.a_lo.begin(), p.a_lo.end());
    result->a_hi.insert(result->a_hi.end(), p.a_hi.begin(), p.a_hi.end());
    result->head_diag.insert(result->head_diag.end(), p.head_diag.begin(),
                             p.head_diag.end());
  }
  return result;
}

// Lookup + chaining from a PREcomputed minimizer list (the on-device scan
// path, align/dev_scan.py): same chaining semantics and output as
// svt_chain3, minus the host scan. Minimizers must be read-major and
// position-sorted within each read (the scan emission order). Threaded
// over read-aligned ranges of the minimizer array.
void* svt_chain4(const int64_t* offsets, int64_t n_reads, int64_t n_mins,
                 const int32_t* m_read, const int32_t* m_pos,
                 const uint32_t* m_hash, const int8_t* m_strand, int32_t k,
                 const uint32_t* uniq_hash, int64_t n_uniq,
                 const int64_t* hit_start, const int32_t* hit_path,
                 const int32_t* hit_pos, const int8_t* hit_strand,
                 int32_t min_anchors, int32_t max_chains, int32_t max_gap,
                 int32_t drift_abs, int32_t drift_permille,
                 int32_t block_rows, int32_t ext_min_anchors,
                 int32_t panel_path_limit, int32_t n_threads,
                 void* lookup) {
  auto* result = new SeedResult();
  if (k <= 0 || k > 15 || n_reads <= 0 || block_rows <= 0 || n_mins <= 0)
    return result;
  SeedIndex idx{uniq_hash,  n_uniq,     hit_start,
                hit_path,   hit_pos,    hit_strand,
                static_cast<const HashLookup*>(lookup)};
  ChainParams cp{min_anchors, max_chains,  max_gap,       drift_abs,
                 drift_permille, block_rows, ext_min_anchors};
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((int64_t)T > n_mins) T = (int)n_mins;
  if (T == 1) {
    chain_mins_range(offsets, m_read, m_pos, m_hash, m_strand, 0, n_mins, k,
                     idx, cp, result, panel_path_limit);
    chain_prof_report("chain4");
    return result;
  }
  // Range bounds: equal minimizer shares, snapped forward to the next
  // read boundary so no read straddles two threads.
  std::vector<int64_t> bounds(T + 1, n_mins);
  bounds[0] = 0;
  for (int t = 1; t < T; ++t) {
    int64_t i = std::max(bounds[t - 1], n_mins * t / T);
    while (i < n_mins && i > 0 && m_read[i] == m_read[i - 1]) ++i;
    bounds[t] = i;
  }
  std::vector<SeedResult> parts(T);
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t]() {
      chain_mins_range(offsets, m_read, m_pos, m_hash, m_strand, bounds[t],
                       bounds[t + 1], k, idx, cp, &parts[t],
                       panel_path_limit);
    });
  }
  for (auto& th : threads) th.join();
  chain_prof_report("chain4");
  size_t n = 0;
  for (const auto& p : parts) n += p.read.size();
  result->read.reserve(n);
  result->path.reserve(n);
  result->strand.reserve(n);
  result->d0.reserve(n);
  result->support.reserve(n);
  result->chain.reserve(n);
  result->q_lo.reserve(n);
  result->q_hi.reserve(n);
  result->a_lo.reserve(n);
  result->a_hi.reserve(n);
  for (const auto& p : parts) {
    result->read.insert(result->read.end(), p.read.begin(), p.read.end());
    result->path.insert(result->path.end(), p.path.begin(), p.path.end());
    result->strand.insert(result->strand.end(), p.strand.begin(),
                          p.strand.end());
    result->d0.insert(result->d0.end(), p.d0.begin(), p.d0.end());
    result->support.insert(result->support.end(), p.support.begin(),
                           p.support.end());
    result->chain.insert(result->chain.end(), p.chain.begin(),
                         p.chain.end());
    result->q_lo.insert(result->q_lo.end(), p.q_lo.begin(), p.q_lo.end());
    result->q_hi.insert(result->q_hi.end(), p.q_hi.begin(), p.q_hi.end());
    result->a_lo.insert(result->a_lo.end(), p.a_lo.begin(), p.a_lo.end());
    result->a_hi.insert(result->a_hi.end(), p.a_hi.begin(), p.a_hi.end());
    result->head_diag.insert(result->head_diag.end(), p.head_diag.begin(),
                             p.head_diag.end());
  }
  return result;
}

// Chaining from the on-device scan's emission bitmask (align/dev_scan.py):
// the TPU decides WHICH k-mer starts are minimizers; this recomputes their
// hashes, applies the panel bitmap + exact lookup, and chains — sharing
// chain_one_read with svt_chain3/svt_chain4. Threaded over read ranges
// balanced by base volume (same partitioning as svt_chain3).
// ``hit_packed`` (nullable): interleaved (path<<33|strand<<32|pos) copy of
// the hit arrays — one cache-miss stream instead of three in the expand
// phase (built once per index in svjedi_tpu/align/index.py).
void* svt_chain6(const int8_t* codes, int64_t n_bases,
                 const int64_t* offsets, int64_t n_reads, int32_t k,
                 int32_t w, const uint8_t* emit_bits,
                 const uint8_t* bitmap, int32_t bitmap_log2,
                 const uint32_t* uniq_hash, int64_t n_uniq,
                 const int64_t* hit_start, const int32_t* hit_path,
                 const int32_t* hit_pos, const int8_t* hit_strand,
                 int32_t min_anchors, int32_t max_chains, int32_t max_gap,
                 int32_t drift_abs, int32_t drift_permille,
                 int32_t block_rows, int32_t ext_min_anchors,
                 int32_t panel_path_limit, int32_t n_threads,
                 void* lookup, const uint64_t* hit_packed) {
  (void)n_bases;
  auto* result = new SeedResult();
  if (k <= 0 || k > 15 || w <= 0 || n_reads <= 0 || block_rows <= 0 ||
      emit_bits == nullptr)
    return result;
  const uint32_t bitmap_mask =
      bitmap ? ((bitmap_log2 >= 32) ? 0xFFFFFFFFu
                                    : ((1u << bitmap_log2) - 1))
             : 0;
  SeedIndex idx{uniq_hash,  n_uniq,     hit_start,
                hit_path,   hit_pos,    hit_strand,
                static_cast<const HashLookup*>(lookup), hit_packed};
  ChainParams cp{min_anchors, max_chains,  max_gap,       drift_abs,
                 drift_permille, block_rows, ext_min_anchors};
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((int64_t)T > n_reads) T = (int)n_reads;
  if (T == 1) {
    chain_bits_range(codes, offsets, 0, n_reads, k, w, emit_bits, bitmap,
                     bitmap_mask, idx, cp, result, panel_path_limit);
    chain_prof_report("chain6");
    return result;
  }
  const int64_t total = offsets[n_reads] - offsets[0];
  std::vector<int64_t> bounds(T + 1, n_reads);
  bounds[0] = 0;
  int64_t r = 0;
  for (int t = 1; t < T; ++t) {
    const int64_t target = offsets[0] + total * t / T;
    while (r < n_reads && offsets[r] < target) ++r;
    bounds[t] = r;
  }
  std::vector<SeedResult> parts(T);
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t]() {
      chain_bits_range(codes, offsets, bounds[t], bounds[t + 1], k, w,
                       emit_bits, bitmap, bitmap_mask, idx, cp, &parts[t],
                       panel_path_limit);
    });
  }
  for (auto& th : threads) th.join();
  chain_prof_report("chain6");
  size_t n = 0;
  for (const auto& p : parts) n += p.read.size();
  result->read.reserve(n);
  result->path.reserve(n);
  result->strand.reserve(n);
  result->d0.reserve(n);
  result->support.reserve(n);
  result->chain.reserve(n);
  result->q_lo.reserve(n);
  result->q_hi.reserve(n);
  result->a_lo.reserve(n);
  result->a_hi.reserve(n);
  for (const auto& p : parts) {
    result->read.insert(result->read.end(), p.read.begin(), p.read.end());
    result->path.insert(result->path.end(), p.path.begin(), p.path.end());
    result->strand.insert(result->strand.end(), p.strand.begin(),
                          p.strand.end());
    result->d0.insert(result->d0.end(), p.d0.begin(), p.d0.end());
    result->support.insert(result->support.end(), p.support.begin(),
                           p.support.end());
    result->chain.insert(result->chain.end(), p.chain.begin(),
                         p.chain.end());
    result->q_lo.insert(result->q_lo.end(), p.q_lo.begin(), p.q_lo.end());
    result->q_hi.insert(result->q_hi.end(), p.q_hi.begin(), p.q_hi.end());
    result->a_lo.insert(result->a_lo.end(), p.a_lo.begin(), p.a_lo.end());
    result->a_hi.insert(result->a_hi.end(), p.a_hi.begin(), p.a_hi.end());
    result->head_diag.insert(result->head_diag.end(), p.head_diag.begin(),
                             p.head_diag.end());
  }
  return result;
}

// ABI-stable wrapper (pre-hit_packed signature).
void* svt_chain5(const int8_t* codes, int64_t n_bases,
                 const int64_t* offsets, int64_t n_reads, int32_t k,
                 int32_t w, const uint8_t* emit_bits,
                 const uint8_t* bitmap, int32_t bitmap_log2,
                 const uint32_t* uniq_hash, int64_t n_uniq,
                 const int64_t* hit_start, const int32_t* hit_path,
                 const int32_t* hit_pos, const int8_t* hit_strand,
                 int32_t min_anchors, int32_t max_chains, int32_t max_gap,
                 int32_t drift_abs, int32_t drift_permille,
                 int32_t block_rows, int32_t ext_min_anchors,
                 int32_t panel_path_limit, int32_t n_threads,
                 void* lookup) {
  return svt_chain6(codes, n_bases, offsets, n_reads, k, w, emit_bits,
                    bitmap, bitmap_log2, uniq_hash, n_uniq, hit_start,
                    hit_path, hit_pos, hit_strand, min_anchors, max_chains,
                    max_gap, drift_abs, drift_permille, block_rows,
                    ext_min_anchors, panel_path_limit, n_threads, lookup,
                    /*hit_packed=*/nullptr);
}

// ABI-stable wrapper (pre-lookup-handle signature).
void* svt_chain2(const int8_t* codes, int64_t n_bases,
                 const int64_t* offsets, int64_t n_reads, int32_t k,
                 int32_t w, const uint8_t* bitmap, int32_t bitmap_log2,
                 const uint32_t* uniq_hash, int64_t n_uniq,
                 const int64_t* hit_start, const int32_t* hit_path,
                 const int32_t* hit_pos, const int8_t* hit_strand,
                 int32_t min_anchors, int32_t max_chains, int32_t max_gap,
                 int32_t drift_abs, int32_t drift_permille,
                 int32_t block_rows, int32_t ext_min_anchors,
                 int32_t panel_path_limit, int32_t n_threads) {
  return svt_chain3(codes, n_bases, offsets, n_reads, k, w, bitmap,
                    bitmap_log2, uniq_hash, n_uniq, hit_start, hit_path,
                    hit_pos, hit_strand, min_anchors, max_chains, max_gap,
                    drift_abs, drift_permille, block_rows, ext_min_anchors,
                    panel_path_limit, n_threads, /*lookup=*/nullptr);
}

// ABI-stable wrapper (pre-panel-limit signature).
void* svt_chain(const int8_t* codes, int64_t n_bases,
                const int64_t* offsets, int64_t n_reads, int32_t k,
                int32_t w, const uint8_t* bitmap, int32_t bitmap_log2,
                const uint32_t* uniq_hash, int64_t n_uniq,
                const int64_t* hit_start, const int32_t* hit_path,
                const int32_t* hit_pos, const int8_t* hit_strand,
                int32_t min_anchors, int32_t max_chains, int32_t max_gap,
                int32_t drift_abs, int32_t drift_permille,
                int32_t block_rows, int32_t ext_min_anchors,
                int32_t n_threads) {
  return svt_chain2(codes, n_bases, offsets, n_reads, k, w, bitmap,
                    bitmap_log2, uniq_hash, n_uniq, hit_start, hit_path,
                    hit_pos, hit_strand, min_anchors, max_chains, max_gap,
                    drift_abs, drift_permille, block_rows, ext_min_anchors,
                    /*panel_path_limit=*/0, n_threads);
}

int64_t svt_seed_count(void* handle) {
  return (int64_t) static_cast<SeedResult*>(handle)->read.size();
}

void svt_chain_copy(void* handle, int32_t* read, int32_t* path,
                    int8_t* strand, int32_t* d0, int32_t* support,
                    int32_t* chain, int32_t* q_lo, int32_t* q_hi,
                    int32_t* a_lo, int32_t* a_hi) {
  auto* r = static_cast<SeedResult*>(handle);
  const size_t n = r->read.size();
  if (n == 0) return;
  memcpy(read, r->read.data(), n * sizeof(int32_t));
  memcpy(path, r->path.data(), n * sizeof(int32_t));
  memcpy(strand, r->strand.data(), n * sizeof(int8_t));
  memcpy(d0, r->d0.data(), n * sizeof(int32_t));
  memcpy(support, r->support.data(), n * sizeof(int32_t));
  memcpy(chain, r->chain.data(), n * sizeof(int32_t));
  memcpy(q_lo, r->q_lo.data(), n * sizeof(int32_t));
  memcpy(q_hi, r->q_hi.data(), n * sizeof(int32_t));
  memcpy(a_lo, r->a_lo.data(), n * sizeof(int32_t));
  memcpy(a_hi, r->a_hi.data(), n * sizeof(int32_t));
}

// Chain head-anchor diagonal per row (the creation-order key; see
// SeedResult::head_diag). Separate copy so the svt_chain_copy ABI stays
// stable for older callers.
void svt_seed_headdiag_copy(void* handle, int32_t* head_diag) {
  auto* r = static_cast<SeedResult*>(handle);
  const size_t n = r->head_diag.size();
  if (n == 0) return;
  memcpy(head_diag, r->head_diag.data(), n * sizeof(int32_t));
}

void svt_seed_free(void* handle) { delete static_cast<SeedResult*>(handle); }

int64_t svt_minimizers_count(void* handle) {
  return (int64_t) static_cast<MinimizerResult*>(handle)->hash.size();
}

void svt_minimizers_copy(void* handle, int32_t* read_id, int32_t* pos,
                         uint32_t* hash, int8_t* strand) {
  auto* r = static_cast<MinimizerResult*>(handle);
  const size_t n = r->hash.size();
  if (n == 0) return;
  memcpy(read_id, r->read_id.data(), n * sizeof(int32_t));
  memcpy(pos, r->pos.data(), n * sizeof(int32_t));
  memcpy(hash, r->hash.data(), n * sizeof(uint32_t));
  memcpy(strand, r->strand.data(), n * sizeof(int8_t));
}

void svt_minimizers_free(void* handle) {
  delete static_cast<MinimizerResult*>(handle);
}

// ---------------------------------------------------------------------------
// Decoy suppression inner loop (== svjedi_tpu/align/decoy.py
// suppress_candidates pair semantics, which remains the tested reference).
// Inputs are per-CHAIN tables, both sorted by read id; for every panel
// chain the same-read decoy chains are scanned, the best "at the locus"
// and best "elsewhere" anchor supports are taken over decoy chains whose
// read-interval overlap covers >= overlap_frac of the panel chain's
// interval, and the chain is suppressed when elsewhere strictly wins.
// Threaded over panel-chain ranges split on read boundaries.
// ---------------------------------------------------------------------------
void svt_suppress2(int64_t n_p, const int32_t* p_read, const int32_t* p_sup,
                   const int64_t* p_qlo, const int64_t* p_qhi,
                   const int32_t* p_cluster, int64_t n_d,
                   const int32_t* d_read, const int32_t* d_path,
                   const int8_t* d_strand, const int32_t* d_sup,
                   const int64_t* d_qlo, const int64_t* d_qhi,
                   const int64_t* d_tlo, const int64_t* d_thi,
                   const int64_t* span_lo, const int64_t* span_hi,
                   int32_t n_chroms, double overlap_frac, int64_t margin,
                   int32_t n_threads, uint8_t* suppressed,
                   int32_t* out_best_other, int32_t* out_best_same) {
  auto run = [&](int64_t i0, int64_t i1) {
    int64_t dlo = 0, dhi = 0;
    for (int64_t i = i0; i < i1; ++i) {
      suppressed[i] = 0;
      if (out_best_other) out_best_other[i] = 0;
      if (out_best_same) out_best_same[i] = 0;
      const int32_t r = p_read[i];
      // advance the decoy window to this read (both tables read-sorted)
      if (i == i0 || (i > i0 && p_read[i - 1] != r)) {
        dlo = std::lower_bound(d_read, d_read + n_d, r) - d_read;
        dhi = std::upper_bound(d_read + dlo, d_read + n_d, r) - d_read;
      }
      if (dlo == dhi) continue;
      const int64_t plen = p_qhi[i] - p_qlo[i];
      if (plen <= 0) continue;
      int32_t best_same = 0, best_other = 0;
      const int64_t cl_base = (int64_t)p_cluster[i] * n_chroms;
      for (int64_t d = dlo; d < dhi; ++d) {
        const int64_t ov_lo = std::max(p_qlo[i], d_qlo[d]);
        const int64_t ov_hi = std::min(p_qhi[i], d_qhi[d]);
        if ((double)(ov_hi - ov_lo) < overlap_frac * (double)plen) continue;
        const int64_t ex_lo = span_lo[cl_base + d_path[d]];
        const int64_t ex_hi = span_hi[cl_base + d_path[d]];
        int64_t g1, g2;
        if (d_strand[d] == 0) {
          g1 = d_tlo[d] + (ov_lo - d_qlo[d]);
          g2 = d_tlo[d] + (ov_hi - d_qlo[d]);
        } else {
          g2 = d_thi[d] - (ov_lo - d_qlo[d]);
          g1 = d_thi[d] - (ov_hi - d_qlo[d]);
        }
        const bool same = (ex_lo <= ex_hi) && g2 >= ex_lo - margin &&
                          g1 <= ex_hi + margin;
        if (same) {
          best_same = std::max(best_same, d_sup[d]);
        } else {
          best_other = std::max(best_other, d_sup[d]);
        }
      }
      if (best_other > std::max(best_same, p_sup[i])) suppressed[i] = 1;
      // Margin evidence for the mapq model: the strongest elsewhere /
      // at-locus explanations of this chain's read interval.
      if (out_best_other) out_best_other[i] = best_other;
      if (out_best_same) out_best_same[i] = best_same;
    }
  };
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((int64_t)T > n_p) T = (int)(n_p > 0 ? n_p : 1);
  if (T == 1 || n_p < 4096) {
    run(0, n_p);
    return;
  }
  std::vector<int64_t> bounds(T + 1, n_p);
  bounds[0] = 0;
  for (int t = 1; t < T; ++t) {
    int64_t b = n_p * t / T;
    // split on read boundaries so the two-pointer reset stays valid
    while (b < n_p && b > 0 && p_read[b] == p_read[b - 1]) ++b;
    bounds[t] = b;
  }
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int t = 0; t < T; ++t)
    threads.emplace_back([&, t]() { run(bounds[t], bounds[t + 1]); });
  for (auto& th : threads) th.join();
}

// ABI-stable wrapper (pre-margin-output signature).
void svt_suppress(int64_t n_p, const int32_t* p_read, const int32_t* p_sup,
                  const int64_t* p_qlo, const int64_t* p_qhi,
                  const int32_t* p_cluster, int64_t n_d,
                  const int32_t* d_read, const int32_t* d_path,
                  const int8_t* d_strand, const int32_t* d_sup,
                  const int64_t* d_qlo, const int64_t* d_qhi,
                  const int64_t* d_tlo, const int64_t* d_thi,
                  const int64_t* span_lo, const int64_t* span_hi,
                  int32_t n_chroms, double overlap_frac, int64_t margin,
                  int32_t n_threads, uint8_t* suppressed) {
  svt_suppress2(n_p, p_read, p_sup, p_qlo, p_qhi, p_cluster, n_d, d_read,
                d_path, d_strand, d_sup, d_qlo, d_qhi, d_tlo, d_thi,
                span_lo, span_hi, n_chroms, overlap_frac, margin, n_threads,
                suppressed, nullptr, nullptr);
}

}  // extern "C"
