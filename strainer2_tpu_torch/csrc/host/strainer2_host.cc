// Host data plane of strainer2_tpu_torch (C++, C ABI bound with ctypes in
// strainer2_tpu_torch/native.py; built at first use into
// build/strainer2_tpu_torch/ with g++ -O3 -std=c++17 -fPIC -shared -lz).
//
// A copy of strainer2_tpu/native/strainer2_host.cc, cut to what the port
// calls:
//   * streaming FASTA/FASTQ(.gz) decode -> 2-bit encode -> dense packed
//     batch buffers (the replacement for the reference's kseq parser,
//     reference src/kseq.h, feeding fixed-shape device buffers),
//   * replay of the reference hash's output row order (djb2 + linear
//     probing + capacity doubling, reference src/BIO_hash.c),
//   * bucket- and cuckoo-table construction, first-encounter unique, count-table row
//     formatting and parsing, kmer_hits parsing, the rolling canonical
//     scanner,
//   * the CPU panel counter, read classifiers and read extractor of the
//     --device cpu routes (and the oracles the checks compare with),
//   * genome_compare's string engine (CompareSet: any k, the CPU default).
// One difference from the original: a counting stream splits a sequence
// longer than one buffer across as many buffers as it needs (s2_next_batch),
// where the original returns -3 once the first split is placed.

#include <sys/mman.h>
#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <memory>
#include <thread>
#include <array>
#include <atomic>
#include <unordered_map>

// ---------------------------------------------------------------------------
// gzip/plain line-less streaming reader
// ---------------------------------------------------------------------------

namespace {

constexpr uint8_t kInvalidBase = 4;

uint8_t g_base_code[256];

struct CodeTableInit {
  CodeTableInit() {
    memset(g_base_code, kInvalidBase, sizeof(g_base_code));
    g_base_code['A'] = g_base_code['a'] = 0;
    g_base_code['C'] = g_base_code['c'] = 1;
    g_base_code['G'] = g_base_code['g'] = 2;
    g_base_code['T'] = g_base_code['t'] = 3;
  }
} g_code_table_init;

// Buffered byte source over zlib (transparently handles plain files).
class ByteSource {
 public:
  explicit ByteSource(const char* path) : f_(gzopen(path, "rb")) {}
  ~ByteSource() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  int peek() {
    if (pos_ == len_ && !fill()) return -1;
    return buf_[pos_];
  }
  int next() {
    if (pos_ == len_ && !fill()) return -1;
    return buf_[pos_++];
  }
  // Append bytes until newline (newline consumed, not appended).
  // Returns false on EOF with nothing read; *had_nl reports whether the
  // line was newline-terminated (kseq's truncation semantics need it).
  bool read_line(std::string* out, bool* had_nl = nullptr) {
    out->clear();
    int c = next();
    if (c < 0) {
      if (had_nl) *had_nl = false;
      return false;
    }
    while (c >= 0 && c != '\n') {
      if (c != '\r') out->push_back(static_cast<char>(c));
      c = next();
    }
    if (had_nl) *had_nl = (c == '\n');
    return true;
  }

 private:
  bool fill() {
    if (!f_) return false;
    int n = gzread(f_, buf_, sizeof(buf_));
    if (n <= 0) return false;
    len_ = n;
    pos_ = 0;
    return true;
  }
  gzFile f_;
  unsigned char buf_[1 << 16];
  int pos_ = 0;
  int len_ = 0;
};

// Streaming FASTA/FASTQ record reader: yields encoded sequences.
// Faithful to kseq_read (reference src/kseq.h:171-211), which every
// reference binary loops with `while (kseq_read(...) >= 0)`:
//   - record start scans BYTES (not lines) to the next '>'/'@' marker, so
//     leading or inter-record garbage is skipped silently;
//   - a FASTA record (or a FASTQ record truncated before its '+') cut off
//     by EOF is yielded as-is;
//   - a FASTQ record with a truncated or length-mismatched quality string
//     is DROPPED and parsing stops (kseq returns -2, ending the caller's
//     loop) — pinned against the reference binary in
//     tests/test_edge_cases.py;
//   - mixed FASTA/FASTQ files parse per record.
class FastxReader {
 public:
  // raw=true yields uppercased ASCII bytes instead of 2-bit codes (the
  // arbitrary-k string engine needs letter identity for IUPAC parity).
  explicit FastxReader(const char* path, bool raw = false)
      : src_(new ByteSource(path)), raw_(raw) {}
  bool ok() const { return src_->ok(); }

  // Returns false at EOF (or after a kseq -2 stop). Encoded bases are
  // appended to *seq (cleared first).
  bool next(std::vector<uint8_t>* seq) {
    seq->clear();
    if (stopped_) return false;
    std::string line;
    bool had_nl = true;
    // ---- record start: byte-scan to the next '>'/'@' marker ----
    if (!have_pending_) {
      while (true) {
        if (!src_->read_line(&line, &had_nl)) return false;
        size_t p = line.find_first_of(">@");
        if (p != std::string::npos) {
          // marker as the very last byte of the file: kseq's name read
          // hits EOF and returns -1 — no record
          if (!had_nl && p + 1 == line.size()) return false;
          break;
        }
      }
    }
    have_pending_ = false;
    // ---- sequence lines until '>', '@', '+' or EOF ----
    bool qual = false;
    size_t seq_len = 0;
    while (true) {
      int c = src_->peek();
      if (c < 0) break;
      if (c == '>' || c == '@') {
        src_->read_line(&line, &had_nl);
        // a bare marker at EOF drops the NEXT record (kseq name read -1)
        if (had_nl || line.size() > 1) have_pending_ = true;
        break;
      }
      src_->read_line(&line, &had_nl);
      if (c == '+') {
        if (!had_nl) {  // EOF inside the '+' line: kseq -2, drop + stop
          stopped_ = true;
          return false;
        }
        qual = true;
        break;
      }
      append_line(line, seq);
      seq_len += line.size();
    }
    if (!qual) return true;  // FASTA — or a FASTQ truncated before '+'
    // ---- quality: whole lines until the length reaches seq_len ----
    size_t qlen = 0;
    while (qlen < seq_len) {
      if (!src_->read_line(&line, &had_nl)) {
        stopped_ = true;  // kseq -2: truncated quality drops + stops
        return false;
      }
      qlen += line.size();
    }
    if (qlen != seq_len) {
      stopped_ = true;  // kseq -2: overlong quality drops + stops
      return false;
    }
    return true;
  }

 private:
  void append_line(const std::string& line, std::vector<uint8_t>* seq) {
    if (raw_) {
      for (char ch : line) {
        uint8_t c = (uint8_t)ch;
        seq->push_back(c >= 'a' && c <= 'z' ? (uint8_t)(c - 32) : c);
      }
    } else {
      for (char ch : line) seq->push_back(g_base_code[(unsigned char)ch]);
    }
  }

  std::unique_ptr<ByteSource> src_;
  bool raw_ = false;
  bool have_pending_ = false;
  bool stopped_ = false;
};

// ---------------------------------------------------------------------------
// dense batch packer (mirrors strainer2_tpu/io/batches.py invariants)
// ---------------------------------------------------------------------------

struct PackStream {
  std::vector<std::string> paths;
  int mode;  // 0 = concatenate files sequentially; 1 = interleave two files
  int k, rows, row_len;
  bool with_read_ids;
  int group_size;
  int64_t max_reads;  // <=0: unlimited

  std::vector<std::unique_ptr<FastxReader>> readers;
  size_t cur_file = 0;
  bool io_error = false;
  int error_kind = 0;  // 1 = unreadable file, 2 = PE2 ended before PE1
  std::string error_path;

  // pending group (reads not yet placed)
  std::vector<std::vector<uint8_t>> group;
  std::vector<std::vector<uint8_t>> carry;  // rest of a split read, then its group
  bool exhausted = false;

  // current buffer cursors (buffer memory provided per next_batch call)
  uint8_t* bases = nullptr;
  int32_t* ids = nullptr;
  int64_t* lengths = nullptr;
  int64_t* win_starts = nullptr;
  int row = 0, col = 0;
  int64_t n_reads = 0;
  bool batch_has_data = false;
};

bool fetch_group(PackStream* s) {
  s->group.clear();
  if (s->exhausted) return false;
  if (s->mode == 1) {
    // PE: one read from each of two files
    std::vector<uint8_t> a, b;
    if (!s->readers[0]->next(&a)) {
      s->exhausted = true;
      return false;
    }
    if (!s->readers[1]->next(&b)) {
      s->exhausted = true;
      s->io_error = true;  // PE2 ended early (caller reports)
      s->error_kind = 2;
      s->error_path = s->paths[1];
      return false;
    }
    s->group.push_back(std::move(a));
    s->group.push_back(std::move(b));
    return true;
  }
  // sequential files, group_size consecutive reads atomic
  for (int g = 0; g < s->group_size;) {
    std::vector<uint8_t> r;
    if (s->cur_file >= s->readers.size()) {
      s->exhausted = true;
      break;
    }
    if (s->readers[s->cur_file]->next(&r)) {
      s->group.push_back(std::move(r));
      ++g;
    } else {
      ++s->cur_file;
    }
  }
  return !s->group.empty();
}

int64_t capacity_left(const PackStream* s) {
  int64_t in_row = s->row_len - s->col;
  if (in_row < s->k) in_row = 0;
  int64_t later = s->rows - s->row - 1;
  if (later < 0) later = 0;
  return in_row + later * (s->row_len - (s->k - 1));
}

// Place one read. Returns false if the buffer filled mid-read (only legal
// for counting streams; caller emits and the placement continues in the
// next buffer via *resume_pos).
bool place_read(PackStream* s, const std::vector<uint8_t>& codes, int64_t rid,
                size_t* resume_pos) {
  int64_t n = (int64_t)codes.size();
  const int64_t width = s->row_len - s->k + 1;
  if (n < s->k) {
    // no windows; boundary collapses onto the next read's span
    if (s->win_starts) {
      int64_t c = s->col < width ? s->col : width;
      s->win_starts[rid] = (int64_t)s->row * width + c;
    }
    return true;
  }
  size_t pos = *resume_pos;
  bool first = (pos == 0);
  while ((int64_t)pos < n) {
    if (s->row_len - s->col < s->k) {
      s->row += 1;
      s->col = 0;
    }
    if (s->row >= s->rows) {
      *resume_pos = pos;
      return false;  // buffer full mid-read
    }
    if (!first) {
      pos -= (size_t)(s->k - 1);  // halo
    } else if (s->win_starts) {
      s->win_starts[rid] = (int64_t)s->row * width + s->col;
    }
    first = false;
    int64_t take = n - (int64_t)pos;
    int64_t room = s->row_len - s->col;
    if (take > room) take = room;
    uint8_t* dst = s->bases + (int64_t)s->row * s->row_len + s->col;
    memcpy(dst, codes.data() + pos, (size_t)take);
    if (s->ids) {
      int32_t* idst = s->ids + (int64_t)s->row * s->row_len + s->col;
      for (int64_t i = 0; i < take; ++i) idst[i] = (int32_t)rid;
    }
    s->col += (int)take;
    pos += (size_t)take;
  }
  // separator
  if (s->row_len - s->col >= 1) {
    s->col += 1;
  } else {
    s->row += 1;
    s->col = 0;
  }
  *resume_pos = 0;
  return true;
}

void reset_buffer(PackStream* s, uint8_t* bases, int32_t* ids, int64_t* lengths,
                  int64_t* win_starts) {
  s->bases = bases;
  s->ids = ids;
  s->lengths = lengths;
  s->win_starts = win_starts;
  memset(bases, kInvalidBase, (size_t)s->rows * s->row_len);
  if (ids) {
    int64_t total = (int64_t)s->rows * s->row_len;
    for (int64_t i = 0; i < total; ++i) ids[i] = -1;
  }
  s->row = 0;
  s->col = 0;
  s->n_reads = 0;
  s->batch_has_data = false;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// mode: 0 sequential (1..n files), 1 = PE interleave of exactly 2 files.
void* s2_open_pack_stream(const char** paths, int n_paths, int mode, int k,
                          int rows, int row_len, int with_read_ids,
                          int group_size, long long max_reads) {
  auto* s = new PackStream();
  s->mode = mode;
  s->k = k;
  s->rows = rows;
  s->row_len = row_len;
  s->with_read_ids = with_read_ids != 0;
  s->group_size = group_size < 1 ? 1 : group_size;
  s->max_reads = max_reads;
  for (int i = 0; i < n_paths; ++i) {
    s->paths.emplace_back(paths[i]);
    s->readers.emplace_back(new FastxReader(paths[i]));
    if (!s->readers.back()->ok()) {
      s->io_error = true;
      s->error_kind = 1;
      s->error_path = paths[i];
    }
  }
  return s;
}

// Fills the provided buffers with the next batch.
// Returns: n_reads > 0, 0 = end of stream, -1 = I/O error, -2 = read too
// large for a read-id (detection) buffer.
//
// A counting stream (no read ids) splits a read that does not fit across
// buffers, as the Python packer does (io/batches.py, _Packer.add): the full
// batch is emitted, and the next one starts with the rest of that read from
// k-1 bases before the cut (so no window is lost or repeated), recorded as a
// read of length 0, followed by the reads of its group not placed yet. The
// rest may be split again, as often as the read needs.
long long s2_next_batch(void* stream, uint8_t* bases, int32_t* read_ids,
                        int64_t* read_lengths, int64_t* window_starts) {
  auto* s = static_cast<PackStream*>(stream);
  if (s->io_error) return -1;
  reset_buffer(s, bases, s->with_read_ids ? read_ids : nullptr, read_lengths,
               s->with_read_ids ? window_starts : nullptr);

  // Places a group: 0 = placed; 1 = no room, emit the current batch first;
  // 2 = a read was split, the batch is full and s->carry holds the rest;
  // -2 = a read of a read-id stream does not fit one buffer.
  auto take_group = [&](std::vector<std::vector<uint8_t>>& gr, bool continues) -> int {
    int64_t need = 0;
    for (auto& r : gr)
      if ((int64_t)r.size() >= s->k) need += (int64_t)r.size() + 1;
    need += (int64_t)gr.size();
    bool over_reads = s->max_reads > 0 &&
                      s->n_reads + (int64_t)gr.size() > s->max_reads;
    if (s->batch_has_data && (capacity_left(s) < need || over_reads)) {
      return 1;
    }
    for (size_t i = 0; i < gr.size(); ++i) {
      const std::vector<uint8_t>& r = gr[i];
      int64_t rid = s->n_reads;
      // a continuation counts as a read of length 0: its length is already
      // in the batch where the read started
      s->lengths[s->n_reads++] = continues && i == 0 ? 0 : (int64_t)r.size();
      s->batch_has_data = true;
      size_t resume = 0;
      if (!place_read(s, r, rid, &resume)) {
        if (s->with_read_ids) return -2;
        size_t halo = (size_t)(s->k - 1);
        size_t cut = resume >= halo ? resume - halo : 0;
        std::vector<std::vector<uint8_t>> rest;
        rest.emplace_back(r.begin() + cut, r.end());
        for (size_t j = i + 1; j < gr.size(); ++j) rest.push_back(std::move(gr[j]));
        s->carry = std::move(rest);
        return 2;
      }
    }
    return 0;
  };

  // the rest of a split read, then its group; a fresh buffer never says 1
  if (!s->carry.empty()) {
    auto gr = std::move(s->carry);
    s->carry.clear();
    if (take_group(gr, true) == 2) return s->n_reads;
  }
  // a group kept pending by the last emit (never beside a carry)
  if (!s->group.empty()) {
    int rc = take_group(s->group, false);
    s->group.clear();
    if (rc == -2) return -2;
    if (rc == 2) return s->n_reads;
  }

  while (fetch_group(s)) {
    int rc = take_group(s->group, false);
    if (rc == 1) return s->n_reads;  // group kept pending for the next batch
    s->group.clear();
    if (rc == 2) return s->n_reads;  // buffer-splitting emit
    if (rc == -2) return -2;
  }
  // PE2-ended-early: emit the completed pairs first; the error surfaces
  // on the next call (entry check)
  if (s->io_error && s->mode == 1 && s->n_reads == 0) return -1;
  return s->n_reads;  // may be 0 == end
}

// Returns the error kind (0 = none, 1 = unreadable file, 2 = PE2 ended
// before PE1) and fills the offending path.
int s2_stream_error(void* stream, char* path_out, int cap) {
  auto* s = static_cast<PackStream*>(stream);
  if (!s->io_error) return 0;
  snprintf(path_out, cap, "%s", s->error_path.c_str());
  return s->error_kind ? s->error_kind : 1;
}

void s2_close_pack_stream(void* stream) { delete static_cast<PackStream*>(stream); }

// ---- reference row-order replay (djb2 / linear probe / doubling) ----------

static inline uint32_t djb2_of_code(uint64_t code, int k) {
  uint32_t h = 5381;
  static const char kAscii[4] = {'A', 'C', 'G', 'T'};
  for (int i = k - 1; i >= 0; --i) {
    // character i (MSB-first) lives at bit 2*(k-1-i)
    char c = kAscii[(code >> (2 * i)) & 3];
    h = (h << 5) + h + (uint32_t)c;
  }
  return h;
}

// codes: distinct canonical k-mers in first-encounter (insertion) order.
// order_out: permutation such that codes[order_out] is printed row order.
int s2_reference_row_order(const uint64_t* codes, long long n, int k,
                           long long initial_capacity, long long* order_out) {
  long long m = initial_capacity;
  if (m == 0) m = 1000;
  if (m < 10) m = 10;

  if (n > 0x7FFFFFFFLL) return -1;  // int32 key ids below

  std::vector<uint32_t> hashes((size_t)n);
  for (long long i = 0; i < n; ++i) hashes[(size_t)i] = djb2_of_code(codes[i], k);

  std::vector<int32_t> table((size_t)m, -1);
  auto insert = [&](long long key, std::vector<int32_t>& tbl, long long cap) {
    long long slot = (long long)(hashes[(size_t)key] % (uint32_t)cap);
    while (tbl[(size_t)slot] != -1) {
      if (++slot == cap) slot = 0;
    }
    tbl[(size_t)slot] = (int32_t)key;
  };

  // A key's probe START slot depends only on its own hash, so the cache
  // line can be prefetched ahead of the (order-dependent) insertions.
  constexpr long long kAhead = 12;
  long long count = 0;  // pre-insert key count (reference h->N)
  for (long long i = 0; i < n; ++i) {
    if (i + kAhead < n && count + kAhead < m / 2)
      __builtin_prefetch(&table[hashes[(size_t)(i + kAhead)] % (uint32_t)m], 1, 1);
    insert(i, table, m);
    if (count >= m / 2) {
      long long new_m = m * 2;
      std::vector<int32_t> nt((size_t)new_m, -1);
      for (long long s = 0; s < m; ++s) {
        if (s + kAhead < m && table[(size_t)(s + kAhead)] != -1)
          __builtin_prefetch(
              &nt[hashes[(size_t)table[(size_t)(s + kAhead)]] % (uint32_t)new_m], 1, 1);
        if (table[(size_t)s] != -1) insert(table[(size_t)s], nt, new_m);
      }
      table.swap(nt);
      m = new_m;
    }
    ++count;
  }

  long long out = 0;
  for (long long s = 0; s < m; ++s)
    if (table[(size_t)s] != -1) order_out[out++] = table[(size_t)s];
  return out == n ? 0 : -1;
}

// ---- cuckoo build ----------------------------------------------------------

static inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

static inline uint32_t cuckoo_slot(uint32_t hi, uint32_t lo, int h_bits, int which) {
  static const uint32_t C[2][3] = {
      {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du},
      {0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du},
  };
  uint32_t x = (hi * C[which][0]) ^ (lo * C[which][1]) ^ C[which][2];
  x = mix32(x);
  return h_bits < 32 ? (x >> (32 - h_bits)) : x;
}

// table: (2*(1<<h_bits)) x 2 uint32, pre-filled by caller with 0xFFFFFFFF.
// Returns 0 on success, -1 on eviction failure (caller retries w/ new salt).
int s2_build_cuckoo(const uint64_t* codes, long long n, int k, int h_bits,
                    uint32_t salt, uint32_t* table, int32_t* slot_of_key) {
  const long long h = 1LL << h_bits;
  const int n_lo = k < 16 ? k : 16;
  std::vector<long long> key_at_slot((size_t)(2 * h), -1);

  // precompute both candidate slots per key in one streaming pass
  std::vector<int32_t> s0v((size_t)n), s1v((size_t)n);
  for (long long i = 0; i < n; ++i) {
    uint64_t code = codes[i];
    uint32_t lo = (uint32_t)(code & ((2 * n_lo < 64) ? ((1ULL << (2 * n_lo)) - 1) : ~0ULL));
    uint32_t hi = (uint32_t)(code >> (2 * n_lo)) ^ salt;
    s0v[(size_t)i] = (int32_t)cuckoo_slot(hi, lo, h_bits, 0);
    s1v[(size_t)i] = (int32_t)(cuckoo_slot(hi, lo, h_bits, 1) + h);
  }

  for (long long i = 0; i < n; ++i) {
    long long cur = i;
    long long s0 = s0v[(size_t)i], s1 = s1v[(size_t)i];
    long long target = key_at_slot[(size_t)s0] < 0 ? s0
                       : key_at_slot[(size_t)s1] < 0 ? s1
                                                     : s0;
    int steps = 0;
    while (true) {
      long long displaced = key_at_slot[(size_t)target];
      key_at_slot[(size_t)target] = cur;
      slot_of_key[cur] = (int32_t)target;
      if (displaced < 0) break;
      if (++steps > 500) return -1;
      cur = displaced;
      s0 = s0v[(size_t)cur];
      s1 = s1v[(size_t)cur];
      target = (slot_of_key[cur] == (int32_t)s0) ? s1 : s0;
    }
  }

  for (long long s = 0; s < 2 * h; ++s) {
    long long key = key_at_slot[(size_t)s];
    if (key >= 0) {
      uint64_t code = codes[key];
      table[2 * s + 1] = (uint32_t)(code & ((2 * n_lo < 64) ? ((1ULL << (2 * n_lo)) - 1) : ~0ULL));
      table[2 * s] = (uint32_t)(code >> (2 * n_lo));
    }
  }
  return 0;
}

// ---- fast scrub-table row formatting ---------------------------------------

// Writes rows [begin, end) into buf; returns bytes written or -1 if cap
// would overflow. 4 columns when c3 == nullptr, else 5.
long long s2_format_scrub_rows(char* buf, long long cap, const uint64_t* codes,
                               const uint32_t* c0, const uint32_t* c1,
                               const uint32_t* c2, const uint32_t* c3,
                               long long begin, long long end, int k) {
  char* p = buf;
  char* limit = buf + cap - (k + 64);
  static const char kAscii[4] = {'A', 'C', 'G', 'T'};
  for (long long i = begin; i < end; ++i) {
    if (p > limit) return -1;
    uint64_t code = codes[i];
    for (int j = k - 1; j >= 0; --j) *p++ = kAscii[(code >> (2 * j)) & 3];
    if (c3)
      p += sprintf(p, "\t%u\t%u\t%u\t%u\n", c0[i], c1[i], c2[i], c3[i]);
    else
      p += sprintf(p, "\t%u\t%u\t%u\n", c0[i], c1[i], c2[i]);
  }
  return (long long)(p - buf);
}

// ---- scrub-count table parsing (filter-stage input) -------------------------
//
// Streams a (possibly gzipped) kmer_scrub_count TSV (reference
// src/kmer_scrub_count.c:134-156 format) into contiguous columns: key bytes
// (+ offsets) and the 4 count columns.  Replaces the per-line Python parse,
// which dominates the filter stage's wall time at strain scale.

struct ScrubParse {
  std::string blob;               // concatenated key bytes
  std::vector<int64_t> offsets;   // n+1 key boundaries into blob
  std::vector<int64_t> c1, c2, c3, c4;
  bool has_drug = false;
  bool bad_row = false;           // a malformed data row
  bool io_error = false;          // gzread failure (corrupt/truncated gzip)
};

// Decimal field at q (optionally negative); advances past the digits.
// Returns nullptr when the field has no digits (the Python twin's int()
// raises there — both parse routes must reject the same inputs).
static inline const char* parse_dec(const char* q, const char* e, long long* out) {
  bool neg = false;
  if (q < e && *q == '-') {
    neg = true;
    ++q;
  }
  long long v = 0;
  const char* digits = q;
  while (q < e && (unsigned char)(*q - '0') <= 9u) v = v * 10 + (*q++ - '0');
  if (q == digits) return nullptr;
  *out = neg ? -v : v;
  return q;
}

// One data row [s, e) — e at (not past) the newline.
static void parse_scrub_row(const char* s, const char* e, ScrubParse* p) {
  if (e > s && e[-1] == '\r') --e;
  if (s == e || *s == '#') return;
  const char* tab = static_cast<const char*>(memchr(s, '\t', (size_t)(e - s)));
  if (!tab) {
    p->bad_row = true;
    return;
  }
  p->blob.append(s, (size_t)(tab - s));
  p->offsets.push_back((int64_t)p->blob.size());
  long long v[4] = {0, 0, 0, 0};
  int nf = 0;
  const char* q = tab + 1;
  while (nf < 4 && q < e) {
    q = parse_dec(q, e, &v[nf]);
    // a numeric field must fill [q, next-tab-or-EOL) exactly — '3x', '-',
    // or an empty field raise in the Python twin and must fail here too
    if (q == nullptr || (q < e && *q != '\t')) {
      nf = 0;
      break;
    }
    ++nf;
    if (q >= e) break;
    ++q;
  }
  if (nf < 3) {
    p->bad_row = true;
    p->offsets.pop_back();
    p->blob.resize((size_t)p->offsets.back());
    return;
  }
  p->c1.push_back(v[0]);
  p->c2.push_back(v[1]);
  p->c3.push_back(v[2]);
  if (nf == 4) {
    p->has_drug = true;
    p->c4.push_back(v[3]);
  } else {
    p->c4.push_back(0);
  }
}

void* s2_parse_scrub_open(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  auto* p = new ScrubParse();
  p->offsets.push_back(0);
  p->blob.reserve((size_t)64 << 20);  // strain-scale guess; grows amortized
  p->offsets.reserve(1 << 21);
  for (auto* col : {&p->c1, &p->c2, &p->c3, &p->c4}) col->reserve(1 << 21);
  std::vector<char> buf((size_t)1 << 20);
  std::string carry;
  bool done = false;
  while (!done && !p->bad_row) {
    int nread = gzread(f, buf.data(), (unsigned)buf.size() - 1);
    if (nread <= 0) {
      if (nread < 0) {
        p->io_error = true;  // decompression error: do NOT treat as EOF
      } else {
        int errnum = 0;
        gzerror(f, &errnum);
        if (errnum != Z_OK && errnum != Z_STREAM_END) p->io_error = true;
      }
      done = true;
      nread = 0;
    }
    buf[(size_t)nread] = '\0';  // terminates the buffer's final row
    const char* cur = buf.data();
    const char* end = buf.data() + nread;
    while (cur < end && !p->bad_row) {
      const char* nl = static_cast<const char*>(memchr(cur, '\n', (size_t)(end - cur)));
      if (!nl) {
        carry.append(cur, (size_t)(end - cur));
        break;
      }
      if (carry.empty()) {
        parse_scrub_row(cur, nl, p);
      } else {
        carry.append(cur, (size_t)(nl - cur));
        parse_scrub_row(carry.c_str(), carry.c_str() + carry.size(), p);
        carry.clear();
      }
      cur = nl + 1;
    }
  }
  if (!carry.empty() && !p->bad_row)
    parse_scrub_row(carry.c_str(), carry.c_str() + carry.size(), p);
  gzclose(f);
  return p;
}

long long s2_parse_scrub_rows(void* h) {
  auto* p = static_cast<ScrubParse*>(h);
  if (p->io_error) return -2;
  if (p->bad_row) return -1;
  return (long long)p->c1.size();
}

long long s2_parse_scrub_blob_size(void* h) {
  return (long long)static_cast<ScrubParse*>(h)->blob.size();
}

int s2_parse_scrub_has_drug(void* h) {
  return static_cast<ScrubParse*>(h)->has_drug ? 1 : 0;
}

void s2_parse_scrub_fill(void* h, char* blob, int64_t* offsets, int64_t* c1,
                         int64_t* c2, int64_t* c3, int64_t* c4) {
  auto* p = static_cast<ScrubParse*>(h);
  memcpy(blob, p->blob.data(), p->blob.size());
  memcpy(offsets, p->offsets.data(), p->offsets.size() * sizeof(int64_t));
  memcpy(c1, p->c1.data(), p->c1.size() * sizeof(int64_t));
  memcpy(c2, p->c2.data(), p->c2.size() * sizeof(int64_t));
  memcpy(c3, p->c3.data(), p->c3.size() * sizeof(int64_t));
  memcpy(c4, p->c4.data(), p->c4.size() * sizeof(int64_t));
}

void s2_parse_scrub_close(void* h) { delete static_cast<ScrubParse*>(h); }

}  // extern "C"

// ---- kmer_hits file parsing (coverage_depth input) --------------------------
//
// Streams a strain_detect kmer_hits file (reference src/strain_detect.c:567
// row format `file\tt1\ti1\tt2\ti2\tkmer`) into columns: interned file-name
// ids, t1+t2 totals, and 2-bit-encoded k-mer codes (the k-mer strings are
// already canonical in the file, so a plain MSB-first encode preserves
// distinctness) — plus the raw '#' summary lines for the Python side.
// Replaces the per-line Python parse, which is the long pole of
// coverage_depth on hit-dense runs.  Any row the strict parser cannot
// handle (non-ACGT k-mer, k-length mismatch, non-numeric count) flags a
// fallback and the caller re-parses in Python — behavior stays identical.

struct HitsParse {
  std::unordered_map<std::string, int32_t> interned;
  std::string last_name;               // rows group by sample file, so the
  int32_t last_id = -1;                // previous row's name almost always
                                       // repeats — skip the map+alloc
  std::string names_blob;              // concatenated distinct col-0 strings
  std::vector<int64_t> name_offsets;   // n_names+1 boundaries
  std::vector<int32_t> name_idx;       // per row
  std::vector<int64_t> totals;         // per row: col1 + col3
  std::vector<uint64_t> codes;         // per row: 2-bit k-mer code
  std::string comments;                // raw '#' lines, newline-terminated
  int klen = -1;                       // k of the first data row (<= 31)
  bool bad_row = false;
  bool io_error = false;
};

static void parse_hits_row(const char* s, const char* e, HitsParse* p) {
  if (e > s && e[-1] == '\r') --e;
  if (s == e) {
    // blank (or CR-only) data line: the Python oracle — and the reference
    // script — raise on it (content[1] of ['']), so the native parse must
    // not silently accept what the canonical path rejects; bad_row sends
    // the caller to the Python parse, which then fails identically.
    p->bad_row = true;
    return;
  }
  if (*s == '#') {
    p->comments.append(s, (size_t)(e - s));
    p->comments.push_back('\n');
    return;
  }
  // field 0: file path (interned)
  const char* tab = static_cast<const char*>(memchr(s, '\t', (size_t)(e - s)));
  if (!tab) {
    p->bad_row = true;
    return;
  }
  size_t name_len = (size_t)(tab - s);
  int32_t id;
  if (p->last_id >= 0 && p->last_name.size() == name_len &&
      memcmp(p->last_name.data(), s, name_len) == 0) {
    id = p->last_id;
  } else {
    std::string name(s, name_len);
    auto it = p->interned.find(name);
    if (it == p->interned.end()) {
      id = (int32_t)p->interned.size();
      p->interned.emplace(std::move(name), id);
      p->names_blob.append(s, name_len);
      p->name_offsets.push_back((int64_t)p->names_blob.size());
    } else {
      id = it->second;
    }
    p->last_name.assign(s, name_len);
    p->last_id = id;
  }
  // fields 1..4: t1, i1, t2, i2 — only t1 and t2 are consumed (reference
  // scripts/coverage_depth.py:84), but each numeric field must fill its
  // span exactly, like the Python int() it replaces
  long long t1 = 0, t2 = 0;
  const char* q = tab + 1;
  for (int f = 1; f <= 4; ++f) {
    const char* ftab =
        static_cast<const char*>(memchr(q, '\t', (size_t)(e - q)));
    if (!ftab) {
      p->bad_row = true;
      return;
    }
    if (f == 1 || f == 3) {
      long long v = 0;
      const char* r = parse_dec(q, ftab, &v);
      if (r != ftab) {
        p->bad_row = true;
        return;
      }
      (f == 1 ? t1 : t2) = v;
    }
    q = ftab + 1;
  }
  // field 5: the k-mer (ends at the next tab, if any — extra fields are
  // ignored exactly as content[5] ignores them)
  const char* ktab = static_cast<const char*>(memchr(q, '\t', (size_t)(e - q)));
  const char* kend = ktab ? ktab : e;
  int kl = (int)(kend - q);
  if (kl < 1 || kl > 31 || (p->klen >= 0 && kl != p->klen)) {
    p->bad_row = true;  // length 0/oversize/mixed: Python path handles
    return;
  }
  // branchless 2-bit encode: table gives 4 for non-ACGT, folded into one
  // validity check after the loop (random bases make a per-base branch
  // mispredict ~every other base)
  static const std::array<uint8_t, 256> kEnc = [] {
    std::array<uint8_t, 256> t{};
    t.fill(4);  // non-ACGT sentinel
    t['A'] = 0;
    t['C'] = 1;
    t['G'] = 2;
    t['T'] = 3;
    return t;
  }();
  uint64_t code = 0;
  uint8_t bad = 0;
  for (const char* c = q; c < kend; ++c) {
    uint8_t b = kEnc[(uint8_t)*c];
    bad |= b;
    code = (code << 2) | (uint64_t)(b & 3);
  }
  if (bad & 4) {
    p->bad_row = true;
    return;
  }
  p->klen = kl;
  p->name_idx.push_back(id);
  p->totals.push_back(t1 + t2);
  p->codes.push_back(code);
}

extern "C" {

void* s2_parse_hits_open(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  auto* p = new HitsParse();
  p->name_offsets.push_back(0);
  std::vector<char> buf((size_t)1 << 20);
  std::string carry;
  bool done = false;
  while (!done && !p->bad_row) {
    int nread = gzread(f, buf.data(), (unsigned)buf.size());
    if (nread <= 0) {
      if (nread < 0) {
        p->io_error = true;
      } else {
        int errnum = 0;
        gzerror(f, &errnum);
        if (errnum != Z_OK && errnum != Z_STREAM_END) p->io_error = true;
      }
      done = true;
      nread = 0;
    }
    const char* cur = buf.data();
    const char* end = buf.data() + nread;
    while (cur < end && !p->bad_row) {
      const char* nl =
          static_cast<const char*>(memchr(cur, '\n', (size_t)(end - cur)));
      if (!nl) {
        carry.append(cur, (size_t)(end - cur));
        break;
      }
      if (carry.empty()) {
        parse_hits_row(cur, nl, p);
      } else {
        carry.append(cur, (size_t)(nl - cur));
        parse_hits_row(carry.c_str(), carry.c_str() + carry.size(), p);
        carry.clear();
      }
      cur = nl + 1;
    }
  }
  if (!carry.empty() && !p->bad_row)
    parse_hits_row(carry.c_str(), carry.c_str() + carry.size(), p);
  gzclose(f);
  return p;
}

long long s2_parse_hits_rows(void* h) {
  auto* p = static_cast<HitsParse*>(h);
  if (p->io_error) return -2;
  if (p->bad_row) return -1;
  return (long long)p->totals.size();
}

long long s2_parse_hits_names(void* h) {
  return (long long)static_cast<HitsParse*>(h)->interned.size();
}

long long s2_parse_hits_names_blob(void* h) {
  return (long long)static_cast<HitsParse*>(h)->names_blob.size();
}

long long s2_parse_hits_comments_blob(void* h) {
  return (long long)static_cast<HitsParse*>(h)->comments.size();
}

void s2_parse_hits_fill(void* h, int32_t* name_idx, int64_t* totals,
                        uint64_t* codes, char* names_blob,
                        int64_t* name_offsets, char* comments) {
  auto* p = static_cast<HitsParse*>(h);
  memcpy(name_idx, p->name_idx.data(), p->name_idx.size() * sizeof(int32_t));
  memcpy(totals, p->totals.data(), p->totals.size() * sizeof(int64_t));
  memcpy(codes, p->codes.data(), p->codes.size() * sizeof(uint64_t));
  memcpy(names_blob, p->names_blob.data(), p->names_blob.size());
  memcpy(name_offsets, p->name_offsets.data(),
         p->name_offsets.size() * sizeof(int64_t));
  memcpy(comments, p->comments.data(), p->comments.size());
}

void s2_parse_hits_close(void* h) { delete static_cast<HitsParse*>(h); }

}  // extern "C"

// ---- streaming canonical k-mer scanner (index-build host path) -------------
//
// Rolling canonical extraction over a FASTA/FASTQ file: fwd/rc codes update
// in O(1) per base (the reference's per-window string rebuild, e.g.
// src/genome_compare.c:1000-1023, becomes two shifts), canonical = max.

extern "C" {

struct ScanStream {
  FastxReader* reader;
  int k;
  std::vector<uint8_t> seq;
  size_t pos = 0;       // next base index within seq
  bool have_seq = false;
  uint64_t fwd = 0, rc = 0;
  int run = 0;          // consecutive valid bases ending at pos-1
  bool done = false;
};

void* s2_open_scan(const char* path, int k) {
  auto* s = new ScanStream();
  s->reader = new FastxReader(path);
  s->k = k;
  if (!s->reader->ok()) s->done = true;
  return s;
}

// 1 when the underlying file opened and parsed as FASTA/FASTQ; lets the
// caller distinguish "unreadable file" from "no valid k-mers" (the
// reference exits on unreadable inputs, e.g. src/genome_compare.c:124-127).
int s2_scan_ok(void* stream) {
  auto* s = static_cast<ScanStream*>(stream);
  return s->reader->ok() ? 1 : 0;
}

// Fill out[0..cap) with canonical codes in scan order; returns count
// (0 = end of stream).
long long s2_scan_next(void* stream, uint64_t* out, long long cap) {
  auto* s = static_cast<ScanStream*>(stream);
  if (s->done) return 0;
  const int k = s->k;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const int rc_shift = 2 * (k - 1);
  long long n = 0;
  while (n < cap) {
    if (!s->have_seq || s->pos >= s->seq.size()) {
      if (!s->reader->next(&s->seq)) {
        s->done = true;
        break;
      }
      s->have_seq = true;
      s->pos = 0;
      s->fwd = s->rc = 0;
      s->run = 0;
    }
    const uint8_t* bases = s->seq.data();
    const size_t len = s->seq.size();
    size_t i = s->pos;
    uint64_t fwd = s->fwd, rc = s->rc;
    int run = s->run;
    while (i < len && n < cap) {
      uint8_t b = bases[i++];
      if (b > 3) {
        run = 0;
        continue;
      }
      fwd = ((fwd << 2) | b) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - b) << rc_shift);
      if (++run >= k) {
        out[n++] = fwd >= rc ? fwd : rc;
      }
    }
    s->pos = i;
    s->fwd = fwd;
    s->rc = rc;
    s->run = run;
  }
  return n;
}

void s2_close_scan(void* stream) {
  auto* s = static_cast<ScanStream*>(stream);
  delete s->reader;
  delete s;
}

}  // extern "C"

// ---- first-encounter-ordered unique (index build) --------------------------

#include <algorithm>

// Allocator for the big long-lived probe tables (unique-encounter hash,
// CountTable).  Sequence matters twice over:
// - memset BEFORE madvise: advising MADV_HUGEPAGE ahead of the first touch
//   makes every fault allocate a huge page through synchronous direct
//   compaction (THP defrag=madvise) — measured 0.3-11 s of stall for a
//   537 MB table on a fragmented host vs ~0.35 s of plain 4 KB faults.
//   Touch first at streaming bandwidth, then advise so khugepaged upgrades
//   the mapping in the background: the probe loops still end up on huge
//   pages (TLB-resident) without ever paying a fault-time stall.
// - memset at all: faulting pages one random probe at a time measured
//   ~4x slower cold than one linear populate pass.
static void* s2_table_alloc(size_t bytes) {
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (mem == MAP_FAILED) return MAP_FAILED;
  memset(mem, 0, bytes);
  madvise(mem, bytes, MADV_HUGEPAGE);
  return mem;
}

extern "C" {

// out_codes/out_counts must have capacity n.  Returns the number of unique
// codes, emitted in order of their first occurrence in the scan.
//
// Open-addressing hash keyed by the packed code: insertion order IS
// first-encounter order (the same structural fact the reference's BIO_hash
// relies on, reference src/BIO_hash.c:123), so one linear pass suffices —
// no sort.
long long s2_unique_encounter(const uint64_t* codes, long long n,
                              uint64_t* out_codes, uint32_t* out_counts) {
  if (n == 0) return 0;
  int bits = 3;
  while ((1LL << bits) < 2 * n) ++bits;  // load factor <= 0.5
  const size_t cap = (size_t)1 << bits;
  const size_t mask = cap - 1;
  struct Slot {       // one cache-line-friendly record per probe
    uint64_t code;
    int64_t idx;
  };
  // Empty sentinel is code == 0 — unreachable for canonical-max codes
  // (max(fwd, rc) == 0 needs both strands all-A AND all-T) — and the
  // literal key 0 is tracked out-of-band for generic (non-canonical) input.
  const size_t bytes = cap * sizeof(Slot);
  void* mem = s2_table_alloc(bytes);
  if (mem == MAP_FAILED) return -1;
  Slot* slots = static_cast<Slot*>(mem);
  long long m = 0;
  long long zero_idx = -1;  // the one key the sentinel can't represent
  // Fibonacci multiplicative hash: full-width mix, top bits as index.
  const auto hash = [bits](uint64_t code) {
    return (size_t)((code * 0x9E3779B97F4A7C15ULL) >> (64 - bits));
  };
  constexpr long long kAhead = 12;  // hide the probe's DRAM miss latency
  for (long long i = 0; i < n; ++i) {
    if (i + kAhead < n)
      __builtin_prefetch(&slots[hash(codes[i + kAhead])], 1, 1);
    const uint64_t code = codes[i];
    if (code == 0) {
      if (zero_idx < 0) {
        zero_idx = m;
        out_codes[m] = code;
        out_counts[m] = 1;
        ++m;
      } else {
        ++out_counts[zero_idx];
      }
      continue;
    }
    size_t s = hash(code);
    for (;;) {
      Slot& slot = slots[s];
      if (slot.code == code) {
        ++out_counts[slot.idx];
        break;
      }
      if (slot.code == 0) {
        slot.code = code;
        slot.idx = m;
        out_codes[m] = code;
        out_counts[m] = 1;
        ++m;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  munmap(mem, bytes);
  return m;
}

}  // extern "C"


// ---- bucketed table construction (single-gather layout) --------------------

extern "C" {

// table: (2**h_bits, row_width) uint32 pre-zeroed EXCEPT caller need not
// init; returns 0 ok, -1 = some bucket overflowed 16 keys (caller retries).
// row_width >= 64: lanes 0:32 hold the two key blocks, 32:row_width the
// meta blocks (strainer2_tpu/index/bucket.py layout).
//
// The table is large (256 B/row at ~20% occupancy), so construction is
// bandwidth-bound: hugepage-advise the range, then split the BUCKET space
// across threads — each thread initializes its half and inserts only the
// keys hashing into it (hashing is cheap next to the random row writes, so
// re-hashing all keys per thread costs less than any synchronization).
int s2_build_bucket_w(const uint64_t* codes, long long n, int k, int h_bits,
                      uint32_t salt, uint32_t* table, int32_t* slot_of_key,
                      int row_width) {
  const long long b_count = 1LL << h_bits;
  const long long rw = row_width;
  const int n_lo = k < 16 ? k : 16;
  // No MADV_HUGEPAGE here: the caller-owned numpy table is untouched, so
  // advising before the row-init writes would pay fault-time direct
  // compaction (seconds of stall, see s2_table_alloc) for a buffer that is
  // written once and read once (jnp.asarray upload).
  std::vector<uint8_t> fill((size_t)b_count, 0);
  std::atomic<int> overflow{0};
  auto build_range = [&](long long b_lo, long long b_hi) {
    for (long long b = b_lo; b < b_hi; ++b) {
      uint32_t* row = table + b * rw;
      for (int j = 0; j < 32; ++j) row[j] = 0xFFFFFFFFu;
      for (long long j = 32; j < rw; ++j) row[j] = 0;
    }
    constexpr long long kAhead = 12;
    for (long long i = 0; i < n; ++i) {
      uint64_t code = codes[i];
      uint32_t lo = (uint32_t)(code & ((2 * n_lo < 64) ? ((1ULL << (2 * n_lo)) - 1) : ~0ULL));
      uint32_t hi = (uint32_t)(code >> (2 * n_lo));
      long long b = cuckoo_slot(hi ^ salt, lo, h_bits, 0);
      if (b < b_lo || b >= b_hi) continue;
      if (i + kAhead < n) {
        uint64_t c2 = codes[i + kAhead];
        uint32_t lo2 = (uint32_t)(c2 & ((2 * n_lo < 64) ? ((1ULL << (2 * n_lo)) - 1) : ~0ULL));
        uint32_t hi2 = (uint32_t)(c2 >> (2 * n_lo));
        __builtin_prefetch(table + cuckoo_slot(hi2 ^ salt, lo2, h_bits, 0) * rw, 1, 1);
      }
      uint8_t cell = fill[(size_t)b];
      if (cell >= 16) {
        overflow.store(1, std::memory_order_relaxed);
        return;
      }
      fill[(size_t)b] = cell + 1;
      uint32_t* row = table + b * rw;
      row[cell] = hi;
      row[16 + cell] = lo;
      slot_of_key[i] = (int32_t)(b * 16 + cell);
    }
  };
  // N-way bucket-range split (each thread re-hashes all keys and writes
  // only its disjoint bucket range — hashing is cheap next to the random
  // row writes, so re-hashing costs less than any synchronization)
  unsigned hw = std::thread::hardware_concurrency();
  long long n_threads = hw ? (long long)hw : 1;
  if (n_threads > 8) n_threads = 8;  // hashing passes scale with threads
  if (n_threads > b_count) n_threads = b_count;
  if (n_threads >= 2 && n > (1 << 16)) {
    std::vector<std::thread> ts;
    for (long long t = 1; t < n_threads; ++t)
      ts.emplace_back(build_range, b_count * t / n_threads,
                      b_count * (t + 1) / n_threads);
    build_range(0, b_count / n_threads);
    for (auto& t : ts) t.join();
  } else {
    build_range(0, b_count);
  }
  return overflow.load() ? -1 : 0;
}


}  // extern "C"

// ---- native panel counting (CPU fast path) ----------------------------------
//
// Fuses the rolling canonical scan with a prefetched exact-hash membership
// lookup and slot-count increment — the whole kmer_scrub_count hot loop
// (reference src/genome_compare.c:179-236) in one pass over the file, no
// batch buffers.  Counts are integer adds into the same slot-indexed array
// the XLA engine uses, so results are bit-identical by construction.

extern "C" {

struct CountTable {
  struct Rec {
    uint64_t code;   // 0 = empty (a canonical-max code can never be 0)
    int32_t slot;
    int32_t pad;
  };
  Rec* recs;
  size_t bytes;
  size_t cap;
  int bits;
  int32_t zero_slot;  // slot for the literal key 0 (generic-input safety)
  // meta words 2+ for >32-strain passes (2 strains' bits land in Rec.slot
  // and Rec.pad; the rest live here, cap-major: extra[p * extra_words + w])
  uint32_t* extra = nullptr;
  size_t extra_bytes = 0;
  int extra_words = 0;
};

void s2_count_free(void* th);

// values_hi (optional, nullable): second 32-bit value word per key,
// stored in the otherwise-padding Rec field — carries strains 16..31 of
// the 64-bit multi-strain meta (pipeline/multi_detect.py 32-per-pass).
void* s2_count_build_impl(const uint64_t* codes, const int32_t* slot_of_key,
                          const int32_t* values_hi, long long n) {
  auto* t = new CountTable();
  int bits = 3;
  while ((1LL << bits) < 2 * n) ++bits;
  t->bits = bits;
  t->cap = (size_t)1 << bits;
  t->bytes = t->cap * sizeof(CountTable::Rec);
  void* mem = s2_table_alloc(t->bytes);  // touch-then-advise: see helper
  if (mem == MAP_FAILED) {
    delete t;
    return nullptr;
  }
  t->recs = static_cast<CountTable::Rec*>(mem);
  t->zero_slot = -1;
  const size_t mask = t->cap - 1;
  const auto hash = [bits](uint64_t c) {
    return (size_t)((c * 0x9E3779B97F4A7C15ULL) >> (64 - bits));
  };
  constexpr long long kAhead = 12;
  for (long long i = 0; i < n; ++i) {
    if (i + kAhead < n)
      __builtin_prefetch(&t->recs[hash(codes[i + kAhead])], 1, 1);
    const uint64_t c = codes[i];
    if (c == 0) {
      t->zero_slot = slot_of_key[i];
      continue;
    }
    size_t p = hash(c);
    while (t->recs[p].code != 0) p = (p + 1) & mask;
    t->recs[p].code = c;
    t->recs[p].slot = slot_of_key[i];
    if (values_hi) t->recs[p].pad = values_hi[i];
  }
  return t;
}

void* s2_count_build(const uint64_t* codes, const int32_t* slot_of_key,
                     long long n) {
  return s2_count_build_impl(codes, slot_of_key, nullptr, n);
}

void* s2_count_build2(const uint64_t* codes, const int32_t* values_lo,
                      const int32_t* values_hi, long long n) {
  return s2_count_build_impl(codes, values_lo, values_hi, n);
}

// n_words >= 1 value words per key, passed planar: words[w * n + i] is
// word w of key i.  Words 0/1 land in Rec.slot/Rec.pad (the cache-resident
// fast pair); words 2+ go to the side array — the >32-strain-per-pass
// meta layout (strainer2_tpu/pipeline/multi_detect.py, 16 strains/word).
void* s2_count_build_multi(const uint64_t* codes, const int32_t* words,
                           long long n, int n_words) {
  auto* t = static_cast<CountTable*>(s2_count_build_impl(
      codes, words, n_words >= 2 ? words + n : nullptr, n));
  if (!t || n_words <= 2) return t;
  const int ew = n_words - 2;
  t->extra_words = ew;
  t->extra_bytes = t->cap * (size_t)ew * sizeof(uint32_t);
  void* mem = s2_table_alloc(t->extra_bytes);  // touch-then-advise
  if (mem == MAP_FAILED) {
    s2_count_free(t);
    return nullptr;
  }
  t->extra = static_cast<uint32_t*>(mem);
  // second pass: re-probe each key to its rec position, fill its words
  const int bits = t->bits;
  const size_t mask = t->cap - 1;
  const auto hash = [bits](uint64_t c) {
    return (size_t)((c * 0x9E3779B97F4A7C15ULL) >> (64 - bits));
  };
  for (long long i = 0; i < n; ++i) {
    const uint64_t c = codes[i];
    if (c == 0) continue;
    size_t p = hash(c);
    while (t->recs[p].code != c) p = (p + 1) & mask;
    for (int w = 0; w < ew; ++w)
      t->extra[p * (size_t)ew + w] = (uint32_t)words[(2 + w) * n + i];
  }
  return t;
}

// Scan one FASTA/FASTQ(.gz) file, counting hits into counts[slot].
// Returns the number of valid windows evaluated, or -1 on I/O error.
long long s2_count_file(void* th, const char* path, int k, uint32_t* counts) {
  auto* t = static_cast<CountTable*>(th);
  void* s = s2_open_scan(path, k);
  if (!s2_scan_ok(s)) {
    s2_close_scan(s);
    return -1;
  }
  std::vector<uint64_t> buf((size_t)1 << 16);
  long long total = 0;
  const int bits = t->bits;
  const size_t mask = t->cap - 1;
  const auto hash = [bits](uint64_t c) {
    return (size_t)((c * 0x9E3779B97F4A7C15ULL) >> (64 - bits));
  };
  constexpr long long kAhead = 12;
  while (true) {
    long long n = s2_scan_next(s, buf.data(), (long long)buf.size());
    if (n <= 0) break;
    total += n;
    for (long long i = 0; i < n; ++i) {
      if (i + kAhead < n)
        __builtin_prefetch(&t->recs[hash(buf[(size_t)(i + kAhead)])], 0, 1);
      const uint64_t c = buf[(size_t)i];
      if (c == 0) {
        if (t->zero_slot >= 0) ++counts[t->zero_slot];
        continue;
      }
      size_t p = hash(c);
      for (;;) {
        const uint64_t cur = t->recs[p].code;
        if (cur == c) {
          ++counts[t->recs[p].slot];
          break;
        }
        if (cur == 0) break;  // not an indexed k-mer
        p = (p + 1) & mask;
      }
    }
  }
  s2_close_scan(s);
  return total;
}

void s2_count_free(void* th) {
  auto* t = static_cast<CountTable*>(th);
  if (t) {
    if (t->extra) munmap(t->extra, t->extra_bytes);
    munmap(t->recs, t->bytes);
    delete t;
  }
}

}  // extern "C"

// ---- native detection classify (CPU fast path) -------------------------------
//
// Per-read (length, total_hits, informative_hits) over a target sample's
// read stream — the quantify_hits_PE hot loop (reference
// src/strain_detect.c:443-541) fused into one native pass: rolling
// canonical windows + prefetched exact-hash lookup against a CountTable
// whose values carry the per-k-mer class (NON_INFORMATIVE=1/INFORMATIVE=2).
// The pair thresholds, summary statistics, and row emission stay in
// Python, fed by these per-read rows (byte-identical aggregation: the
// same integer counts in the same read order).

extern "C" {

struct ClassifyStream {
  FastxReader* r1 = nullptr;
  FastxReader* r2 = nullptr;
  int mode = 0;  // 0 = SE, 1 = PE two-file, 2 = PEI (one file, interleaved)
  int k = 31;
  CountTable* table = nullptr;
  int state = 0;  // 0 ok; 3 = PE2 ended before PE1
  bool done = false;
  std::vector<uint8_t> seq;
  std::vector<uint64_t> codes;
};

static void classify_one_read(CountTable* t, const std::vector<uint8_t>& seq,
                              int k, std::vector<uint64_t>& codes,
                              uint32_t* tot, uint32_t* inf) {
  codes.clear();
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const int rc_shift = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int run = 0;
  for (uint8_t b : seq) {
    if (b > 3) {
      run = 0;
      continue;
    }
    fwd = ((fwd << 2) | b) & mask;
    rc = (rc >> 2) | ((uint64_t)(3 - b) << rc_shift);
    if (++run >= k) codes.push_back(fwd >= rc ? fwd : rc);
  }
  const int bits = t->bits;
  const size_t cmask = t->cap - 1;
  const auto hash = [bits](uint64_t c) {
    return (size_t)((c * 0x9E3779B97F4A7C15ULL) >> (64 - bits));
  };
  constexpr long long kAhead = 12;
  uint32_t n_tot = 0, n_inf = 0;
  const long long n = (long long)codes.size();
  for (long long i = 0; i < n; ++i) {
    if (i + kAhead < n)
      __builtin_prefetch(&t->recs[hash(codes[(size_t)(i + kAhead)])], 0, 1);
    const uint64_t c = codes[(size_t)i];
    if (c == 0) {
      if (t->zero_slot >= 0) {
        ++n_tot;
        if (t->zero_slot == 2) ++n_inf;
      }
      continue;
    }
    size_t p = hash(c);
    for (;;) {
      const uint64_t cur = t->recs[p].code;
      if (cur == c) {
        ++n_tot;
        if (t->recs[p].slot == 2) ++n_inf;
        break;
      }
      if (cur == 0) break;
      p = (p + 1) & cmask;
    }
  }
  *tot = n_tot;
  *inf = n_inf;
}

void* s2_open_classify(const char* p1, const char* p2, int mode, int k,
                       void* table) {
  auto* s = new ClassifyStream();
  s->mode = mode;
  s->k = k;
  s->table = static_cast<CountTable*>(table);
  s->r1 = new FastxReader(p1);
  if (!s->r1->ok()) s->done = true;
  if (mode == 1) {
    s->r2 = new FastxReader(p2);
    if (!s->r2->ok()) s->done = true;
  }
  return s;
}

// 0 = both inputs readable; 1 = file1 unreadable; 2 = file2 unreadable.
int s2_classify_ok(void* h) {
  auto* s = static_cast<ClassifyStream*>(h);
  if (!s->r1->ok()) return 1;
  if (s->mode == 1 && !s->r2->ok()) return 2;
  return 0;
}

// Fill up to cap per-read rows (pairs stay atomic in paired modes).
// Returns the row count (0 = end of stream; check s2_classify_state).
long long s2_classify_next(void* h, int64_t* lens, uint32_t* tot,
                           uint32_t* inf, long long cap) {
  auto* s = static_cast<ClassifyStream*>(h);
  if (s->done) return 0;
  long long n = 0;
  const long long step = (s->mode == 0) ? 1 : 2;
  while (n + step <= cap) {
    if (!s->r1->next(&s->seq)) {
      s->done = true;
      break;
    }
    lens[n] = (int64_t)s->seq.size();
    classify_one_read(s->table, s->seq, s->k, s->codes, &tot[n], &inf[n]);
    ++n;
    if (s->mode == 1) {
      if (!s->r2->next(&s->seq)) {
        s->done = true;
        s->state = 3;  // PE2 ended before PE1 (reference errors here)
        break;
      }
      lens[n] = (int64_t)s->seq.size();
      classify_one_read(s->table, s->seq, s->k, s->codes, &tot[n], &inf[n]);
      ++n;
    } else if (s->mode == 2) {
      if (!s->r1->next(&s->seq)) {
        s->done = true;  // odd read count: Python mirrors the reference error
        break;
      }
      lens[n] = (int64_t)s->seq.size();
      classify_one_read(s->table, s->seq, s->k, s->codes, &tot[n], &inf[n]);
      ++n;
    }
  }
  return n;
}

int s2_classify_state(void* h) {
  return static_cast<ClassifyStream*>(h)->state;
}

void s2_close_classify(void* h) {
  auto* s = static_cast<ClassifyStream*>(h);
  delete s->r1;
  delete s->r2;
  delete s;
}

// ---- forward-only read extraction (emission of passing reads) ---------------

struct ExtractStream {
  FastxReader* reader = nullptr;
  long long next_ordinal = 0;
  std::vector<uint8_t> seq;
};

void* s2_open_extract(const char* path) {
  auto* s = new ExtractStream();
  s->reader = new FastxReader(path);
  return s;
}

int s2_extract_ok(void* h) {
  return static_cast<ExtractStream*>(h)->reader->ok() ? 1 : 0;
}

// Encoded bases of read #ordinal (0-based, ascending across calls).
// Returns the read length (truncated to cap), or -1 past end of file.
long long s2_extract_read(void* h, long long ordinal, uint8_t* out,
                          long long cap) {
  auto* s = static_cast<ExtractStream*>(h);
  while (s->next_ordinal <= ordinal) {
    if (!s->reader->next(&s->seq)) return -1;
    ++s->next_ordinal;
  }
  long long n = (long long)s->seq.size();
  if (n > cap) n = cap;
  memcpy(out, s->seq.data(), (size_t)n);
  return n;
}

void s2_close_extract(void* h) {
  auto* s = static_cast<ExtractStream*>(h);
  delete s->reader;
  delete s;
}

}  // extern "C"

// ---- native multi-strain classify (CPU fast path for detect-multi) ----------
//
// Same stream plumbing as s2_classify_next, but the hash value is the
// packed per-strain meta word (bit 2s = strain s has the k-mer, bit 2s+1 =
// informative for strain s — pipeline/multi_detect.py); per-read outputs
// are (cap, n_strains) C-order total/informative rows.

extern "C" {

static void classify_one_read_multi(CountTable* t, const std::vector<uint8_t>& seq,
                                    int k, std::vector<uint64_t>& codes,
                                    uint32_t* tot, uint32_t* inf, int n_strains) {
  codes.clear();
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const int rc_shift = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int run = 0;
  for (uint8_t b : seq) {
    if (b > 3) {
      run = 0;
      continue;
    }
    fwd = ((fwd << 2) | b) & mask;
    rc = (rc >> 2) | ((uint64_t)(3 - b) << rc_shift);
    if (++run >= k) codes.push_back(fwd >= rc ? fwd : rc);
  }
  for (int s = 0; s < n_strains; ++s) tot[s] = inf[s] = 0;
  const int bits = t->bits;
  const size_t cmask = t->cap - 1;
  const auto hash = [bits](uint64_t c) {
    return (size_t)((c * 0x9E3779B97F4A7C15ULL) >> (64 - bits));
  };
  // SWAR vertical counters (the CPU twin of ops/segsum._field_sums16):
  // instead of 2S scalar bit extracts per hit window, each 16-strain meta
  // word accumulates IN packed form — strain s's 1-bit value sits at bit
  // 2s, so mask 0x11111111 picks the even strains already on a 4-bit
  // stride and (w >> 2) & 0x11111111 the odd ones.  Four uint32
  // accumulators per word hold 8 4-bit counters each (cap 15), flushed
  // into the int totals every 15 hits.  ~5 ops per plane per 16 strains
  // instead of 32 — the classify inner cost stops growing 2S-per-hit.
  // All-integer and order-preserving, hence byte-identical (pinned by
  // tests/test_multi_detect.py native-vs-jit at 20/40/130 strains).
  const int n_words = (n_strains + 15) / 16;  // word 0 = slot, 1 = pad, 2+ extra
  uint32_t accTe[16], accTo[16], accIe[16], accIo[16];
  for (int w = 0; w < n_words; ++w) accTe[w] = accTo[w] = accIe[w] = accIo[w] = 0;
  int pending = 0;
  auto flush = [&]() {
    for (int w = 0; w < n_words; ++w) {
      const int base = 16 * w;
      const int lim = n_strains - base < 16 ? n_strains - base : 16;
      for (int j = 0; 2 * j < lim; ++j) {
        tot[base + 2 * j] += (accTe[w] >> (4 * j)) & 0xFu;
        inf[base + 2 * j] += (accIe[w] >> (4 * j)) & 0xFu;
        if (2 * j + 1 < lim) {
          tot[base + 2 * j + 1] += (accTo[w] >> (4 * j)) & 0xFu;
          inf[base + 2 * j + 1] += (accIo[w] >> (4 * j)) & 0xFu;
        }
      }
      accTe[w] = accTo[w] = accIe[w] = accIo[w] = 0;
    }
    pending = 0;
  };
  constexpr long long kAhead = 12;
  const long long n = (long long)codes.size();
  for (long long i = 0; i < n; ++i) {
    if (i + kAhead < n)
      __builtin_prefetch(&t->recs[hash(codes[(size_t)(i + kAhead)])], 0, 1);
    const uint64_t c = codes[(size_t)i];
    if (c == 0) continue;  // canonical-max codes are never 0
    size_t p = hash(c);
    bool found = false;
    for (;;) {
      const uint64_t cur = t->recs[p].code;
      if (cur == c) {
        found = true;
        break;
      }
      if (cur == 0) break;
      p = (p + 1) & cmask;
    }
    if (found) {
      const uint32_t* extra = t->extra_words
          ? &t->extra[p * (size_t)t->extra_words] : nullptr;
      for (int w = 0; w < n_words; ++w) {
        const uint32_t word =
            w == 0 ? (uint32_t)t->recs[p].slot
                   : w == 1 ? (uint32_t)t->recs[p].pad : extra[w - 2];
        const uint32_t pres = word & 0x55555555u;
        const uint32_t info = (word >> 1) & 0x55555555u;
        accTe[w] += pres & 0x11111111u;
        accTo[w] += (pres >> 2) & 0x11111111u;
        accIe[w] += info & 0x11111111u;
        accIo[w] += (info >> 2) & 0x11111111u;
      }
      if (++pending == 15) flush();
    }
  }
  if (pending) flush();
}

// Per-read rows into (cap, n_strains) C-order buffers; same pairing and
// state semantics as s2_classify_next.
long long s2_classify_multi_next(void* h, int64_t* lens, uint32_t* tot,
                                 uint32_t* inf, long long cap, int n_strains) {
  auto* s = static_cast<ClassifyStream*>(h);
  if (s->done) return 0;
  long long n = 0;
  const long long step = (s->mode == 0) ? 1 : 2;
  auto one = [&](long long row) {
    lens[row] = (int64_t)s->seq.size();
    classify_one_read_multi(s->table, s->seq, s->k, s->codes,
                            &tot[row * n_strains], &inf[row * n_strains],
                            n_strains);
  };
  while (n + step <= cap) {
    if (!s->r1->next(&s->seq)) {
      s->done = true;
      break;
    }
    one(n++);
    if (s->mode == 1) {
      if (!s->r2->next(&s->seq)) {
        s->done = true;
        s->state = 3;
        break;
      }
      one(n++);
    } else if (s->mode == 2) {
      if (!s->r1->next(&s->seq)) {
        s->done = true;
        break;
      }
      one(n++);
    }
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// arbitrary-k genome_compare string engine (k > 32 path)
//
// Native equivalent of the reference's variable-seed containment scorer
// (reference src/genome_compare.c:271-354 GEN_calculate_coverage and
// :475-521 GEN_hash_sequences): canonical = lexicographic max of the raw
// character window vs its IUPAC reverse complement (forward wins ties),
// windows containing 'N' skipped, hybrid rapid mode decided at exactly
// the max_seeds-th evaluated window.  Semantics are pinned byte-identical
// to the Python twin pipeline/compare.py::_HostSetComparer.
// ---------------------------------------------------------------------------

namespace {

uint8_t g_comp_char[256];
struct CompCharInit {
  CompCharInit() {
    for (int i = 0; i < 256; ++i) g_comp_char[i] = (uint8_t)i;
    const char* a = "ABCDGHKMNRSTUVWXY";
    const char* b = "TVGHCD.KNYSAABWXR";  // incl. the reference's K -> '.'
    for (size_t i = 0; a[i]; ++i) g_comp_char[(uint8_t)a[i]] = (uint8_t)b[i];
  }
} g_comp_char_init;

struct CompareSet {
  struct Rec {
    uint64_t h;     // FNV-1a of the key (0 = empty sentinel; real 0 remapped)
    int64_t off;    // key offset into arena (off * k bytes)
  };
  std::vector<char> arena;   // n * k canonical key bytes
  Rec* recs = nullptr;       // huge-page mmap: random probes are TLB-bound
  size_t recs_bytes = 0;
  size_t cap = 0, mask = 0, n = 0;
  int k = 0;

  ~CompareSet() {
    if (recs) munmap(recs, recs_bytes);
  }

  static uint64_t fnv1a(const char* p, int k) {
    uint64_t h = 1469598103934665603ULL;
    for (int i = 0; i < k; ++i) {
      h ^= (uint8_t)p[i];
      h *= 1099511628211ULL;
    }
    return h ? h : 1;  // 0 is the empty-slot sentinel
  }

  bool init(size_t cap0) {
    if (recs) munmap(recs, recs_bytes);
    cap = cap0;
    mask = cap - 1;
    recs_bytes = cap * sizeof(Rec);
    void* mem = s2_table_alloc(recs_bytes);  // touch-then-advise
    if (mem == MAP_FAILED) {
      recs = nullptr;
      return false;
    }
    recs = static_cast<Rec*>(mem);
    return true;
  }

  bool grow() {
    Rec* old = recs;
    size_t old_bytes = recs_bytes;
    size_t old_cap = cap;
    recs = nullptr;
    if (!init(old_cap * 2)) {
      recs = old;
      recs_bytes = old_bytes;
      cap = old_cap;
      mask = cap - 1;
      return false;
    }
    for (size_t i = 0; i < old_cap; ++i) {
      if (!old[i].h) continue;
      size_t p = old[i].h & mask;
      while (recs[p].h) p = (p + 1) & mask;
      recs[p] = old[i];
    }
    munmap(old, old_bytes);
    return true;
  }

  bool failed = false;  // grow() allocation failure: abort the build
                        // (a table at 100% load would probe forever)

  bool insert(const char* key, uint64_t h) {
    if (failed) return false;
    size_t p = h & mask;
    while (recs[p].h) {
      if (recs[p].h == h &&
          memcmp(arena.data() + recs[p].off * k, key, k) == 0)
        return true;
      p = (p + 1) & mask;
    }
    int64_t off = (int64_t)n;
    arena.insert(arena.end(), key, key + k);
    recs[p] = Rec{h, off};
    if (++n * 2 >= cap && !grow()) failed = true;
    return !failed;
  }

  bool contains(const char* key, uint64_t h) const {
    size_t p = h & mask;
    for (;;) {
      const Rec& r = recs[p];
      if (!r.h) return false;
      if (r.h == h && memcmp(arena.data() + r.off * k, key, k) == 0)
        return true;
      p = (p + 1) & mask;
    }
  }
};

// Per-record scan state: uppercased seq, whole-sequence reverse
// complement, and N prefix counts (window [i, i+k) has an N iff
// npre[i + k] > npre[i]).
struct CompareScan {
  std::vector<uint8_t> seq;
  std::vector<char> rc;
  std::vector<int32_t> npre;

  bool prep(int k) {
    int64_t len = (int64_t)seq.size();
    if (len < k) return false;
    rc.resize(len);
    npre.resize(len + 1);
    npre[0] = 0;
    for (int64_t i = 0; i < len; ++i) {
      rc[(size_t)(len - 1 - i)] = (char)g_comp_char[seq[(size_t)i]];
      npre[(size_t)i + 1] = npre[(size_t)i] + (seq[(size_t)i] == 'N');
    }
    return true;
  }

  // canonical window pointer: max(fwd, rc window), forward wins ties
  const char* canon(int64_t i, int k) const {
    const char* fwd = (const char*)seq.data() + i;
    const char* rcw = rc.data() + ((int64_t)seq.size() - k - i);
    return memcmp(fwd, rcw, (size_t)k) >= 0 ? fwd : rcw;
  }
};

}  // namespace

extern "C" {

void* s2_compare_build(const char* a_file, int k) {
  FastxReader r(a_file, /*raw=*/true);
  if (!r.ok()) return nullptr;
  auto* cs = new CompareSet();
  cs->k = k;
  // pass 1: load + prep all records (the reference also holds the whole
  // -a genome in memory, src/genome_compare.c:454-473) and count windows
  // so the table is sized once — no rehash during the insert sweep.
  std::vector<CompareScan> recs;
  long long total = 0;
  {
    CompareScan sc;
    while (r.next(&sc.seq)) {
      if (!sc.prep(k)) continue;
      total += (long long)sc.seq.size() - k + 1;
      recs.push_back(std::move(sc));
      sc = CompareScan();
    }
  }
  size_t cap = 1 << 10;
  while ((long long)cap < 2 * (total > 1 ? total : 1)) cap <<= 1;
  if (!cs->init(cap)) {
    delete cs;
    return nullptr;
  }
  cs->arena.reserve((size_t)(total > 0 ? total : 0) * (size_t)k);
  // pass 2: software-pipelined inserts (prefetch the probe start kAhead
  // windows ahead — same trick as s2_count_build)
  constexpr int64_t kAhead = 8;
  const char* pend_key[kAhead];
  uint64_t pend_h[kAhead];
  for (const auto& sc : recs) {
    const int64_t nw = (int64_t)sc.seq.size() - k + 1;
    int64_t npend = 0;
    for (int64_t i = 0; i < nw; ++i) {
      if (sc.npre[(size_t)(i + k)] > sc.npre[(size_t)i]) continue;
      const char* key = sc.canon(i, k);
      uint64_t h = CompareSet::fnv1a(key, k);
      __builtin_prefetch(&cs->recs[h & cs->mask], 1, 1);
      int64_t slot = npend % kAhead;
      if (npend >= kAhead && !cs->insert(pend_key[slot], pend_h[slot])) break;
      pend_key[slot] = key;
      pend_h[slot] = h;
      ++npend;
    }
    for (int64_t j = npend >= kAhead ? npend - kAhead : 0; j < npend; ++j) {
      int64_t slot = j % kAhead;
      if (!cs->insert(pend_key[slot], pend_h[slot])) break;
    }
    if (cs->failed) break;
  }
  if (cs->failed) {  // out of memory mid-build: report, don't hang later
    delete cs;
    return nullptr;
  }
  return cs;
}

long long s2_compare_size(void* h) {
  return (long long)static_cast<CompareSet*>(h)->n;
}

// Score one query file.  Returns 0 on success (-1 unreadable file);
// *hits/*misses receive the tallies.  max_seeds == 0 means full scan.
int s2_compare_score(void* h, const char* path, long long max_seeds,
                     double threshold, long long* hits_out,
                     long long* misses_out) {
  auto* cs = static_cast<CompareSet*>(h);
  const int k = cs->k;
  FastxReader r(path, /*raw=*/true);
  if (!r.ok()) return -1;
  long long hits = 0, misses = 0;
  bool fullmap = max_seeds == 0;
  CompareScan sc;
  constexpr int64_t kAhead = 8;
  const char* pend_key[kAhead];
  uint64_t pend_h[kAhead];
  while (r.next(&sc.seq)) {
    if (!sc.prep(k)) continue;
    const int64_t nw = (int64_t)sc.seq.size() - k + 1;
    int64_t i = 0;
    // careful region: per-window rapid-mode decision (few windows)
    while (i < nw && max_seeds && !fullmap) {
      if (sc.npre[(size_t)(i + k)] == sc.npre[(size_t)i]) {
        const char* key = sc.canon(i, k);
        if (cs->contains(key, CompareSet::fnv1a(key, k))) ++hits; else ++misses;
      }
      ++i;
      if (hits + misses >= max_seeds) {
        if ((double)hits / (double)(hits + misses) > threshold) {
          fullmap = true;
        } else {
          *hits_out = hits;
          *misses_out = misses;
          return 0;
        }
      }
    }
    // fast region: software-pipelined probes for the rest of the record
    int64_t npend = 0;
    for (; i < nw; ++i) {
      if (sc.npre[(size_t)(i + k)] > sc.npre[(size_t)i]) continue;
      const char* key = sc.canon(i, k);
      uint64_t hh = CompareSet::fnv1a(key, k);
      __builtin_prefetch(&cs->recs[hh & cs->mask], 0, 1);
      int64_t slot = npend % kAhead;
      if (npend >= kAhead) {
        if (cs->contains(pend_key[slot], pend_h[slot])) ++hits; else ++misses;
      }
      pend_key[slot] = key;
      pend_h[slot] = hh;
      ++npend;
    }
    for (int64_t j = npend >= kAhead ? npend - kAhead : 0; j < npend; ++j) {
      int64_t slot = j % kAhead;
      if (cs->contains(pend_key[slot], pend_h[slot])) ++hits; else ++misses;
    }
  }
  *hits_out = hits;
  *misses_out = misses;
  return 0;
}

void s2_compare_free(void* h) { delete static_cast<CompareSet*>(h); }

}  // extern "C"
