// A self-contained Zstandard decoder (RFC 8878), for reading the orbax
// releases (OCDBT nodes and zarr chunks are zstd frames) where no zstd
// library is installed. It decodes, with every read bounds-checked:
//
//   * frames one after another, skippable frames skipped; the frame header
//     (window, single segment, content size, which is checked when given),
//     and the optional XXH64 content checksum, verified when present;
//   * raw, RLE and compressed blocks;
//   * literals: raw, RLE, Huffman-coded with direct or FSE-coded weights,
//     one or four streams, and treeless blocks that reuse the last table;
//   * sequences: predefined, RLE, FSE-coded and repeat modes for each of
//     the three codes, the three repeat offsets, and matches that overlap
//     their own output.
//
// No dictionaries: a frame that names one fails. The C interface:
//
//   long long zstd_decode(const uint8_t *src, size_t n, uint8_t *dst, size_t cap)
//       the bytes written, or a negative error code (zstd_error_name);
//       ZSTD_ERR_DST_TOO_SMALL when the output would exceed cap;
//   const char *zstd_error_name(long long code);
//   uint32_t crc32c(const uint8_t *src, size_t n)
//       CRC-32C (Castagnoli), the checksum of an OCDBT node.
//
// Build: c++ -std=c++17 -O2 -shared -fPIC -o libzstd_decode.so zstd_decode.cc

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

enum Error : int {
  ERR_SRC_TRUNCATED = 1,
  ERR_DST_TOO_SMALL = 2,
  ERR_BAD_MAGIC = 3,
  ERR_RESERVED_BIT = 4,
  ERR_DICTIONARY = 5,
  ERR_BLOCK_TYPE = 6,
  ERR_BLOCK_SIZE = 7,
  ERR_LITERALS = 8,
  ERR_HUFFMAN = 9,
  ERR_FSE = 10,
  ERR_SEQUENCES = 11,
  ERR_OFFSET = 12,
  ERR_CHECKSUM = 13,
  ERR_CONTENT_SIZE = 14,
  ERR_BITSTREAM = 15,
  ERR_INTERNAL = 16,
};

const char *const kErrorNames[] = {
    "ok",
    "source truncated",
    "destination too small",
    "not a zstd frame (bad magic number)",
    "reserved bit set",
    "frame needs a dictionary",
    "reserved block type",
    "block larger than the maximum",
    "corrupt literals section",
    "corrupt Huffman table",
    "corrupt FSE table",
    "corrupt sequences section",
    "match offset beyond the decoded data",
    "content checksum mismatch",
    "decoded size differs from the frame content size",
    "bitstream not consumed exactly",
    "internal error",
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

inline int highbit32(uint32_t x) { return 31 - __builtin_clz(x); }

inline uint64_t load_le(const uint8_t *p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------------------
// Bit readers
// ---------------------------------------------------------------------------

// A forward little-endian bit reader (the FSE table descriptions).
struct ForwardBits {
  const uint8_t *src;
  size_t len;
  size_t bit = 0;

  ForwardBits(const uint8_t *s, size_t n) : src(s), len(n) {}

  uint32_t read(int n) {
    if (n == 0) return 0;
    if (bit + n > len * 8) fail(ERR_SRC_TRUNCATED);
    uint32_t v = 0;
    for (int i = 0; i < n; i++, bit++) v |= uint32_t((src[bit >> 3] >> (bit & 7)) & 1) << i;
    return v;
  }
  void rewind(int n) { bit -= n; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// A backward bit reader (Huffman and FSE streams): the stream is read from
// its last bit towards its first; the highest set bit of the last byte marks
// the start. Reading past the first bit yields zeros, and `pos` goes
// negative, which the callers test.
struct BackwardBits {
  const uint8_t *src;
  size_t len;
  int64_t pos;

  BackwardBits(const uint8_t *s, size_t n) : src(s), len(n) {
    if (n == 0) fail(ERR_BITSTREAM);
    uint8_t last = s[n - 1];
    if (last == 0) fail(ERR_BITSTREAM);
    pos = int64_t(n - 1) * 8 + highbit32(last);
  }

  // Bits [p, p + n) of the stream, n <= 56; bits below 0 read as zero.
  inline uint64_t bits_at(int64_t p, int n) const {
    if (p < 0) {
      if (p + n <= 0) return 0;
      return bits_at(0, int(n + p)) << (-p);
    }
    size_t byte = size_t(p >> 3);
    int shift = int(p & 7);
    uint64_t v;
    if (byte + 8 <= len) {
      memcpy(&v, src + byte, 8);
    } else {
      v = load_le(src + byte, int(len - byte));
    }
    return (v >> shift) & ((uint64_t(1) << n) - 1);
  }

  inline uint64_t read(int n) {
    if (n == 0) return 0;
    pos -= n;
    return bits_at(pos, n);
  }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

constexpr int kMaxFseLog = 9;

struct FseTable {
  int accuracy_log = 0;
  uint8_t symbol[1 << kMaxFseLog];
  uint8_t num_bits[1 << kMaxFseLog];
  uint16_t base[1 << kMaxFseLog];
};

// The decoding table of normalized counts `freq` (-1: a "less than one"
// probability) over `n` symbols.
void fse_build(FseTable &t, const int16_t *freq, int n, int accuracy_log) {
  const int size = 1 << accuracy_log;
  uint16_t next[256];
  int high = size;
  for (int s = 0; s < n; s++) {
    if (freq[s] == -1) {
      t.symbol[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n; s++) {
    if (freq[s] <= 0) continue;
    next[s] = uint16_t(freq[s]);
    for (int i = 0; i < freq[s]; i++) {
      t.symbol[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail(ERR_FSE);
  for (int i = 0; i < size; i++) {
    uint16_t x = next[t.symbol[i]]++;
    int nb = accuracy_log - highbit32(x);
    t.num_bits[i] = uint8_t(nb);
    t.base[i] = uint16_t((uint32_t(x) << nb) - size);
  }
  t.accuracy_log = accuracy_log;
}

// Reads an FSE table description at `src`; returns the bytes it took.
size_t fse_read_table(FseTable &t, const uint8_t *src, size_t n, int max_log, int max_symbol) {
  ForwardBits in(src, n);
  const int accuracy_log = int(in.read(4)) + 5;
  if (accuracy_log > max_log) fail(ERR_FSE);
  int remaining = 1 << accuracy_log;
  int16_t freq[256];
  int s = 0;
  while (remaining > 0) {
    if (s > max_symbol) fail(ERR_FSE);
    const int bits = highbit32(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.read(bits);
    const uint32_t lower_mask = (uint32_t(1) << (bits - 1)) - 1;
    const uint32_t threshold = (uint32_t(1) << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower_mask) < threshold) {
      in.rewind(1);
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    const int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    freq[s++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        const uint32_t repeat = in.read(2);
        for (uint32_t i = 0; i < repeat; i++) {
          if (s > max_symbol) fail(ERR_FSE);
          freq[s++] = 0;
        }
        if (repeat != 3) break;
      }
    }
  }
  if (remaining != 0) fail(ERR_FSE);
  fse_build(t, freq, s, accuracy_log);
  return in.bytes_used();
}

// A table whose every state gives `symbol` and reads no bits.
void fse_rle(FseTable &t, uint8_t symbol) {
  t.accuracy_log = 0;
  t.symbol[0] = symbol;
  t.num_bits[0] = 0;
  t.base[0] = 0;
}

struct FseState {
  const FseTable *t;
  uint32_t state;

  void init(const FseTable &table, BackwardBits &in) {
    t = &table;
    state = uint32_t(in.read(table.accuracy_log));
  }
  uint8_t peek() const { return t->symbol[state]; }
  void update(BackwardBits &in) { state = t->base[state] + uint32_t(in.read(t->num_bits[state])); }
};

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

constexpr int kMaxHuffBits = 11;

struct HuffTable {
  int max_bits = 0;
  uint8_t symbol[1 << kMaxHuffBits];
  uint8_t num_bits[1 << kMaxHuffBits];
};

// The table of `n` weights; the last symbol's weight is implied.
void huff_build(HuffTable &t, uint8_t *weights, int n) {
  if (n < 1 || n > 255) fail(ERR_HUFFMAN);
  uint32_t sum = 0;
  for (int i = 0; i < n; i++) {
    if (weights[i] > kMaxHuffBits + 1) fail(ERR_HUFFMAN);
    if (weights[i]) sum += uint32_t(1) << (weights[i] - 1);
  }
  if (sum == 0) fail(ERR_HUFFMAN);
  const int max_bits = highbit32(sum) + 1;
  if (max_bits > kMaxHuffBits) fail(ERR_HUFFMAN);
  const uint32_t left = (uint32_t(1) << max_bits) - sum;
  if (left == 0 || (left & (left - 1)) != 0) fail(ERR_HUFFMAN);
  weights[n] = uint8_t(highbit32(left) + 1);
  n++;
  uint8_t bits[256];
  int rank_count[kMaxHuffBits + 2] = {0};
  for (int i = 0; i < n; i++) {
    bits[i] = weights[i] ? uint8_t(max_bits + 1 - weights[i]) : 0;
    rank_count[bits[i]]++;
  }
  // Codes of max_bits bits (the least weight) come first in the table.
  uint32_t rank_idx[kMaxHuffBits + 2];
  rank_idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; b--) {
    rank_idx[b - 1] = rank_idx[b] + uint32_t(rank_count[b]) * (uint32_t(1) << (max_bits - b));
    memset(t.num_bits + rank_idx[b], b, rank_idx[b - 1] - rank_idx[b]);
  }
  if (rank_idx[0] != (uint32_t(1) << max_bits)) fail(ERR_HUFFMAN);
  for (int i = 0; i < n; i++) {
    if (!bits[i]) continue;
    const uint32_t code = rank_idx[bits[i]];
    const uint32_t len = uint32_t(1) << (max_bits - bits[i]);
    memset(t.symbol + code, i, len);
    rank_idx[bits[i]] += len;
  }
  t.max_bits = max_bits;
}

// Reads a Huffman tree description; returns the bytes it took.
size_t huff_read_table(HuffTable &t, const uint8_t *src, size_t n) {
  if (n < 1) fail(ERR_SRC_TRUNCATED);
  const uint8_t header = src[0];
  uint8_t weights[257];
  int count = 0;
  size_t used;
  if (header >= 128) {
    count = header - 127;
    used = 1 + size_t((count + 1) / 2);
    if (used > n) fail(ERR_SRC_TRUNCATED);
    for (int i = 0; i < count; i++) {
      const uint8_t byte = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? uint8_t(byte >> 4) : uint8_t(byte & 15);
    }
  } else {
    used = 1 + size_t(header);
    if (used > n || header == 0) fail(ERR_SRC_TRUNCATED);
    FseTable ft;
    const size_t table_bytes = fse_read_table(ft, src + 1, header, 6, 255);
    if (table_bytes >= header) fail(ERR_HUFFMAN);
    BackwardBits in(src + 1 + table_bytes, header - table_bytes);
    FseState s1, s2;
    s1.init(ft, in);
    s2.init(ft, in);
    // Two interleaved states until the stream overflows; then the other
    // state's symbol is the last.
    for (;;) {
      if (count > 253) fail(ERR_HUFFMAN);
      weights[count++] = s1.peek();
      s1.update(in);
      if (in.pos < 0) {
        weights[count++] = s2.peek();
        break;
      }
      weights[count++] = s2.peek();
      s2.update(in);
      if (in.pos < 0) {
        weights[count++] = s1.peek();
        break;
      }
    }
  }
  huff_build(t, weights, count);
  return used;
}

// Decodes `n` symbols of one Huffman stream into `dst`. The table is
// indexed by the next max_bits bits of the stream (zeros past its start); a
// symbol consumes its code's bits. Five symbols at a time take at most 55
// bits of one 64-bit load, while the load lies inside the stream; the
// stream must end exactly with the last symbol.
void huff_stream(const HuffTable &t, const uint8_t *src, size_t len, uint8_t *dst, size_t n) {
  BackwardBits in(src, len);
  const int max_bits = t.max_bits;
  const int drop = 64 - max_bits;
  int64_t pos = in.pos;
  size_t i = 0;
  while (i + 5 <= n) {
    const int64_t top = (pos + 7) >> 3;
    if (top < 8) break;
    uint64_t c;
    memcpy(&c, src + top - 8, 8);
    c <<= (top * 8 - pos);
    for (int k = 0; k < 5; k++) {
      const uint32_t idx = uint32_t(c >> drop);
      dst[i++] = t.symbol[idx];
      const int nb = t.num_bits[idx];
      c <<= nb;
      pos -= nb;
    }
  }
  for (; i < n; i++) {
    const uint32_t idx = uint32_t(in.bits_at(pos - max_bits, max_bits));
    dst[i] = t.symbol[idx];
    pos -= t.num_bits[idx];
    if (pos < 0) fail(ERR_HUFFMAN);
  }
  if (pos != 0) fail(ERR_BITSTREAM);
}

// ---------------------------------------------------------------------------
// Sequences: codes and predefined distributions
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,   18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,   18,   19,    20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,   34,   35,   37,   39,    41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr int kLLMaxSymbol = 35, kMLMaxSymbol = 52, kOFMaxSymbol = 31;
constexpr int kLLMaxLog = 9, kMLMaxLog = 9, kOFMaxLog = 8;
constexpr size_t kMaxBlock = 128 * 1024;

// ---------------------------------------------------------------------------
// Frames and blocks
// ---------------------------------------------------------------------------

// What a frame's blocks share: the last Huffman table (for treeless
// literals), the last sequence tables (for repeat mode) and the repeat
// offsets.
struct FrameState {
  HuffTable huff;
  bool have_huff = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  uint8_t literals[kMaxBlock];
};

struct Output {
  uint8_t *dst;
  size_t cap;
  size_t pos;
  size_t frame_start;

  void need(size_t n) const {
    if (n > cap - pos) fail(ERR_DST_TOO_SMALL);
  }
};

// Decodes the literals section; returns the bytes it took and sets *count.
size_t decode_literals(FrameState &fs, const uint8_t *src, size_t n, size_t *count) {
  if (n < 1) fail(ERR_SRC_TRUNCATED);
  const int type = src[0] & 3;
  const int size_format = (src[0] >> 2) & 3;
  if (type == 0 || type == 1) {
    size_t header, regen;
    if ((size_format & 1) == 0) {
      header = 1;
      regen = src[0] >> 3;
    } else if (size_format == 1) {
      header = 2;
      if (n < 2) fail(ERR_SRC_TRUNCATED);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      header = 3;
      if (n < 3) fail(ERR_SRC_TRUNCATED);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (regen > kMaxBlock) fail(ERR_LITERALS);
    *count = regen;
    if (type == 0) {
      if (header + regen > n) fail(ERR_SRC_TRUNCATED);
      memcpy(fs.literals, src + header, regen);
      return header + regen;
    }
    if (header + 1 > n) fail(ERR_SRC_TRUNCATED);
    memset(fs.literals, src[header], regen);
    return header + 1;
  }
  size_t header;
  int bits;
  bool four;
  switch (size_format) {
    case 0: header = 3; bits = 10; four = false; break;
    case 1: header = 3; bits = 10; four = true; break;
    case 2: header = 4; bits = 14; four = true; break;
    default: header = 5; bits = 18; four = true; break;
  }
  if (n < header) fail(ERR_SRC_TRUNCATED);
  const uint64_t h = load_le(src, int(header));
  const size_t mask = (size_t(1) << bits) - 1;
  const size_t regen = size_t(h >> 4) & mask;
  const size_t csize = size_t(h >> (4 + bits)) & mask;
  if (regen > kMaxBlock) fail(ERR_LITERALS);
  if (header + csize > n) fail(ERR_SRC_TRUNCATED);
  const uint8_t *p = src + header;
  size_t left = csize;
  if (type == 2) {
    const size_t used = huff_read_table(fs.huff, p, left);
    fs.have_huff = true;
    p += used;
    left -= used;
  } else if (!fs.have_huff) {
    fail(ERR_LITERALS);
  }
  if (!four) {
    huff_stream(fs.huff, p, left, fs.literals, regen);
  } else {
    if (left < 6) fail(ERR_LITERALS);
    const size_t s1 = load_le(p, 2), s2 = load_le(p + 2, 2), s3 = load_le(p + 4, 2);
    if (6 + s1 + s2 + s3 > left) fail(ERR_LITERALS);
    const size_t s4 = left - 6 - s1 - s2 - s3;
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail(ERR_LITERALS);
    const uint8_t *q = p + 6;
    huff_stream(fs.huff, q, s1, fs.literals, seg);
    huff_stream(fs.huff, q + s1, s2, fs.literals + seg, seg);
    huff_stream(fs.huff, q + s1 + s2, s3, fs.literals + 2 * seg, seg);
    huff_stream(fs.huff, q + s1 + s2 + s3, s4, fs.literals + 3 * seg, regen - 3 * seg);
  }
  *count = regen;
  return header + csize;
}

// Reads one code's table in `mode`; returns the bytes it took.
size_t sequence_table(FseTable &t, bool &have, int mode, const uint8_t *src, size_t n, const int16_t *defaults,
                      int n_defaults, int default_log, int max_log, int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(t, defaults, n_defaults, default_log);
      have = true;
      return 0;
    case 1:
      if (n < 1) fail(ERR_SRC_TRUNCATED);
      if (src[0] > max_symbol) fail(ERR_SEQUENCES);
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      const size_t used = fse_read_table(t, src, n, max_log, max_symbol);
      have = true;
      return used;
    }
    default:
      if (!have) fail(ERR_SEQUENCES);
      return 0;
  }
}

void copy_literals(Output &out, const uint8_t *lit, size_t n) {
  out.need(n);
  memcpy(out.dst + out.pos, lit, n);
  out.pos += n;
}

void decode_compressed_block(FrameState &fs, Output &out, const uint8_t *src, size_t n) {
  size_t n_lit = 0;
  const size_t lit_bytes = decode_literals(fs, src, n, &n_lit);
  const uint8_t *p = src + lit_bytes;
  size_t left = n - lit_bytes;
  if (left < 1) fail(ERR_SRC_TRUNCATED);
  size_t n_seq = p[0];
  size_t header = 1;
  if (n_seq >= 128) {
    if (n_seq < 255) {
      if (left < 2) fail(ERR_SRC_TRUNCATED);
      n_seq = ((n_seq - 128) << 8) + p[1];
      header = 2;
    } else {
      if (left < 3) fail(ERR_SRC_TRUNCATED);
      n_seq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      header = 3;
    }
  }
  p += header;
  left -= header;
  const uint8_t *lit = fs.literals;
  size_t lit_left = n_lit;
  if (n_seq == 0) {
    if (left != 0) fail(ERR_SEQUENCES);
    copy_literals(out, lit, lit_left);
    return;
  }
  if (left < 1) fail(ERR_SRC_TRUNCATED);
  const uint8_t modes = p[0];
  if (modes & 3) fail(ERR_RESERVED_BIT);
  p++;
  left--;
  size_t used = sequence_table(fs.ll, fs.have_ll, modes >> 6, p, left, kLLDefault, 36, 6, kLLMaxLog, kLLMaxSymbol);
  p += used;
  left -= used;
  used = sequence_table(fs.of, fs.have_of, (modes >> 4) & 3, p, left, kOFDefault, 29, 5, kOFMaxLog, kOFMaxSymbol);
  p += used;
  left -= used;
  used = sequence_table(fs.ml, fs.have_ml, (modes >> 2) & 3, p, left, kMLDefault, 53, 6, kMLMaxLog, kMLMaxSymbol);
  p += used;
  left -= used;

  BackwardBits in(p, left);
  FseState ll, of, ml;
  ll.init(fs.ll, in);
  of.init(fs.of, in);
  ml.init(fs.ml, in);
  for (size_t i = 0; i < n_seq; i++) {
    const uint8_t of_code = of.peek(), ml_code = ml.peek(), ll_code = ll.peek();
    if (of_code > kOFMaxSymbol || ml_code > kMLMaxSymbol || ll_code > kLLMaxSymbol) fail(ERR_SEQUENCES);
    const uint64_t offset_value = (uint64_t(1) << of_code) + in.read(of_code);
    const size_t match = kMLBase[ml_code] + size_t(in.read(kMLBits[ml_code]));
    const size_t literal = kLLBase[ll_code] + size_t(in.read(kLLBits[ll_code]));
    if (in.pos < 0) fail(ERR_SEQUENCES);
    uint64_t offset;
    if (offset_value > 3) {
      offset = offset_value - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      const unsigned idx = unsigned(offset_value - 1) + (literal == 0 ? 1 : 0);
      if (idx == 0) {
        offset = fs.rep[0];
      } else {
        offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
        if (idx > 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (i + 1 < n_seq) {
      ll.update(in);
      ml.update(in);
      of.update(in);
      if (in.pos < 0) fail(ERR_SEQUENCES);
    }
    if (literal > lit_left) fail(ERR_SEQUENCES);
    copy_literals(out, lit, literal);
    lit += literal;
    lit_left -= literal;
    if (offset == 0 || offset > out.pos - out.frame_start) fail(ERR_OFFSET);
    out.need(match);
    uint8_t *d = out.dst + out.pos;
    const uint8_t *s = d - offset;
    if (offset >= match) {
      memcpy(d, s, match);
    } else {
      for (size_t k = 0; k < match; k++) d[k] = s[k];
    }
    out.pos += match;
  }
  if (in.pos != 0) fail(ERR_BITSTREAM);
  copy_literals(out, lit, lit_left);
}

// ---------------------------------------------------------------------------
// XXH64 and CRC-32C
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL, P3 = 0x165667B19E3779F9ULL,
                   P4 = 0x85EBCA77C2B2AE63ULL, P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t input) { return rotl64(acc + input * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t val) { return (acc ^ xxh_round(0, val)) * P1 + P4; }

uint64_t xxh64(const uint8_t *p, size_t len) {
  const uint8_t *end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xxh_round(v1, load_le(p, 8));
      v2 = xxh_round(v2, load_le(p + 8, 8));
      v3 = xxh_round(v3, load_le(p + 16, 8));
      v4 = xxh_round(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (end - p >= 8) {
    h ^= xxh_round(0, load_le(p, 8));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= load_le(p, 4) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[i] = c;
    }
  }
};

const Crc32cTable kCrc32c;

// Decodes one frame at src; returns the source bytes it took.
size_t decode_frame(FrameState &fs, Output &out, const uint8_t *src, size_t n) {
  if (n < 4) fail(ERR_SRC_TRUNCATED);
  const uint32_t magic = uint32_t(load_le(src, 4));
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail(ERR_SRC_TRUNCATED);
    const size_t size = size_t(load_le(src + 4, 4));
    if (size > n - 8) fail(ERR_SRC_TRUNCATED);
    return 8 + size;
  }
  if (magic != 0xFD2FB528u) fail(ERR_BAD_MAGIC);
  size_t p = 4;
  if (n < p + 1) fail(ERR_SRC_TRUNCATED);
  const uint8_t fhd = src[p++];
  const int fcs_flag = fhd >> 6;
  const bool single_segment = (fhd >> 5) & 1;
  const bool checksum = (fhd >> 2) & 1;
  const int did_flag = fhd & 3;
  if (fhd & 8) fail(ERR_RESERVED_BIT);
  uint64_t window = 0;
  if (!single_segment) {
    if (n < p + 1) fail(ERR_SRC_TRUNCATED);
    const uint8_t wd = src[p++];
    const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
    window = base + (base / 8) * (wd & 7);
  }
  const int did_bytes[4] = {0, 1, 2, 4};
  if (n < p + did_bytes[did_flag]) fail(ERR_SRC_TRUNCATED);
  const uint64_t dictionary = load_le(src + p, did_bytes[did_flag]);
  p += did_bytes[did_flag];
  if (dictionary != 0) fail(ERR_DICTIONARY);
  const int fcs_bytes[4] = {single_segment ? 1 : 0, 2, 4, 8};
  const int fb = fcs_bytes[fcs_flag];
  bool have_size = fb > 0;
  uint64_t content_size = 0;
  if (n < p + fb) fail(ERR_SRC_TRUNCATED);
  if (have_size) {
    content_size = load_le(src + p, fb);
    if (fb == 2) content_size += 256;
  }
  p += fb;
  if (single_segment) window = content_size;
  const uint64_t block_max = window < kMaxBlock ? window : kMaxBlock;

  fs.have_huff = fs.have_ll = fs.have_of = fs.have_ml = false;
  fs.rep[0] = 1;
  fs.rep[1] = 4;
  fs.rep[2] = 8;
  out.frame_start = out.pos;
  for (;;) {
    if (n < p + 3) fail(ERR_SRC_TRUNCATED);
    const uint32_t bh = uint32_t(load_le(src + p, 3));
    p += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail(ERR_BLOCK_TYPE);
    if (size > block_max) fail(ERR_BLOCK_SIZE);
    if (type == 1) {
      if (n < p + 1) fail(ERR_SRC_TRUNCATED);
      out.need(size);
      memset(out.dst + out.pos, src[p], size);
      out.pos += size;
      p += 1;
    } else {
      if (n < p + size) fail(ERR_SRC_TRUNCATED);
      if (type == 0) {
        copy_literals(out, src + p, size);
      } else {
        const size_t before = out.pos;
        decode_compressed_block(fs, out, src + p, size);
        if (out.pos - before > block_max) fail(ERR_BLOCK_SIZE);
      }
      p += size;
    }
    if (last) break;
  }
  if (have_size && out.pos - out.frame_start != content_size) fail(ERR_CONTENT_SIZE);
  if (checksum) {
    if (n < p + 4) fail(ERR_SRC_TRUNCATED);
    const uint32_t want = uint32_t(load_le(src + p, 4));
    const uint32_t got = uint32_t(xxh64(out.dst + out.frame_start, out.pos - out.frame_start));
    if (want != got) fail(ERR_CHECKSUM);
    p += 4;
  }
  return p;
}

}  // namespace

extern "C" {

long long zstd_decode(const uint8_t *src, size_t n, uint8_t *dst, size_t cap) {
  static thread_local FrameState *fs = nullptr;
  if (fs == nullptr) fs = new FrameState();
  Output out{dst, cap, 0, 0};
  try {
    if (n == 0) fail(ERR_SRC_TRUNCATED);
    size_t p = 0;
    while (p < n) p += decode_frame(*fs, out, src + p, n - p);
  } catch (const Fail &f) {
    return -f.code;
  } catch (...) {
    return -ERR_INTERNAL;
  }
  return (long long)out.pos;
}

const char *zstd_error_name(long long code) {
  const long long k = -code;
  if (k < 0 || k >= (long long)(sizeof(kErrorNames) / sizeof(kErrorNames[0]))) return "unknown error";
  return kErrorNames[k];
}

long long zstd_error_dst_too_small(void) { return -ERR_DST_TOO_SMALL; }

uint32_t crc32c(const uint8_t *src, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = kCrc32c.t[(c ^ src[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
