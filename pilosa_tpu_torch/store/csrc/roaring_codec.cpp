// Native host codec for the pilosa 64-bit roaring format.
//
// pilosa_tpu_torch's copy of native/roaring_codec.cpp: fragment snapshot
// parse/serialize, dense-word expansion straight into a plane's staging
// slab, and the sorted uint32 union/difference behind row writes.  Its
// output is byte-identical to pilosa_tpu/store/roaring.py and to the
// port's numpy codec (store/roaring.py), which the tests hold it to.
// store/native.py builds it with g++ on first use and loads it through
// ctypes; there is no Python fallback.
//
// C ABI.  All functions return >= 0 on success, negative error codes on
// failure.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint16_t kMagic = 12348;
constexpr uint16_t kVersion = 0;
constexpr int kTypeArray = 1;
constexpr int kTypeBitmap = 2;
constexpr int kTypeRun = 3;
constexpr size_t kArrayMax = 4096;

constexpr int64_t ERR_SHORT = -1;     // truncated buffer
constexpr int64_t ERR_MAGIC = -2;     // wrong magic/version
constexpr int64_t ERR_TYPE = -3;      // bad container type
constexpr int64_t ERR_CAP = -4;       // output buffer too small
constexpr int64_t ERR_ORDER = -5;     // positions not sorted/unique

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline void wr16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void wr32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline void wr64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

struct ContainerRef {
  uint64_t key;
  int type;
  uint32_t card;
  const uint8_t* data;
  size_t data_len;  // valid bytes from data
};

// Parse headers; fills refs. Returns container count or error.
int64_t parse_headers(const uint8_t* buf, size_t len,
                      std::vector<ContainerRef>& refs) {
  if (len < 8) return ERR_SHORT;
  if (rd16(buf) != kMagic || rd16(buf + 2) != kVersion) return ERR_MAGIC;
  uint32_t n = rd32(buf + 4);
  size_t pos = 8;
  if (len < pos + 12ull * n + 4ull * n) return ERR_SHORT;
  refs.resize(n);
  for (uint32_t i = 0; i < n; i++) {
    refs[i].key = rd64(buf + pos);
    refs[i].type = rd16(buf + pos + 8);
    refs[i].card = (uint32_t)rd16(buf + pos + 10) + 1;
    pos += 12;
  }
  for (uint32_t i = 0; i < n; i++) {
    uint32_t off = rd32(buf + pos);
    pos += 4;
    if (off > len) return ERR_SHORT;
    refs[i].data = buf + off;
    refs[i].data_len = len - off;
  }
  return (int64_t)n;
}

// Expand one container's low-16 values into out (capacity 65536 entries:
// array cardinality and bitmap popcount are bounded by the format, but
// RUN containers in a malformed blob can overlap/repeat, so runs are
// validated as strictly ascending and non-overlapping — otherwise this
// would write past out (untrusted input reaches here via import-roaring,
// cluster merges, and snapshot files).
int64_t expand_container(const ContainerRef& c, uint16_t* out) {
  switch (c.type) {
    case kTypeArray: {
      if (c.data_len < 2ull * c.card) return ERR_SHORT;
      std::memcpy(out, c.data, 2ull * c.card);
      return c.card;
    }
    case kTypeBitmap: {
      if (c.data_len < 8192) return ERR_SHORT;
      size_t n = 0;
      for (int w = 0; w < 1024; w++) {
        uint64_t word = rd64(c.data + 8 * w);
        while (word) {
          int b = __builtin_ctzll(word);
          out[n++] = (uint16_t)(w * 64 + b);
          word &= word - 1;
        }
      }
      return (int64_t)n;
    }
    case kTypeRun: {
      if (c.data_len < 2) return ERR_SHORT;
      uint16_t nruns = rd16(c.data);
      if (c.data_len < 2ull + 4ull * nruns) return ERR_SHORT;
      size_t n = 0;
      int64_t prev_last = -1;
      for (uint16_t r = 0; r < nruns; r++) {
        uint32_t start = rd16(c.data + 2 + 4 * r);
        uint32_t last = rd16(c.data + 2 + 4 * r + 2);
        if (last < start || (int64_t)start <= prev_last) return ERR_ORDER;
        prev_last = (int64_t)last;
        if (n + (last - start + 1) > 65536) return ERR_ORDER;
        for (uint32_t v = start; v <= last; v++) out[n++] = (uint16_t)v;
      }
      return (int64_t)n;
    }
    default:
      return ERR_TYPE;
  }
}

}  // namespace

extern "C" {

// Total set-bit count of a serialized bitmap (for output sizing).
int64_t rc_cardinality(const uint8_t* buf, size_t len) {
  std::vector<ContainerRef> refs;
  int64_t n = parse_headers(buf, len, refs);
  if (n < 0) return n;
  int64_t total = 0;
  for (auto& c : refs) total += c.card;
  return total;
}

// blob -> sorted uint64 positions. out must hold rc_cardinality entries.
int64_t rc_deserialize(const uint8_t* buf, size_t len, uint64_t* out,
                       size_t out_cap) {
  std::vector<ContainerRef> refs;
  int64_t n = parse_headers(buf, len, refs);
  if (n < 0) return n;
  size_t total = 0;
  uint16_t lows[65536];
  for (auto& c : refs) {
    int64_t m = expand_container(c, lows);
    if (m < 0) return m;
    if (total + (size_t)m > out_cap) return ERR_CAP;
    uint64_t hi = c.key << 16;
    for (int64_t i = 0; i < m; i++) out[total + i] = hi | lows[i];
    total += (size_t)m;
  }
  return (int64_t)total;
}

// Expand a blob straight into a dense packed-word plane:
//   plane is uint32[n_rows * words_per_row]; a position p maps to
//   row = p / row_width, bit = p % row_width.  row_slots maps row ids to
//   plane rows: row_slots[i] = row id of plane slot i (sorted ascending).
// Positions whose row has no slot are skipped.  The zero-copy host->HBM
// feed path (SURVEY.md §8 "host->HBM streaming").
int64_t rc_expand_plane(const uint8_t* buf, size_t len, uint64_t row_width,
                        const uint64_t* row_slots, size_t n_rows,
                        uint32_t* plane, size_t words_per_row) {
  std::vector<ContainerRef> refs;
  int64_t n = parse_headers(buf, len, refs);
  if (n < 0) return n;
  uint16_t lows[65536];
  int64_t set = 0;
  // cache the last row lookup: containers come in ascending position
  // order so runs of the same row are common
  size_t slot = 0;
  bool slot_ok = false;
  uint64_t slot_row = ~0ull;
  auto lookup = [&](uint64_t row) {
    if (row == slot_row) return;
    slot_row = row;
    slot_ok = false;
    size_t lo = 0, hi = n_rows;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (row_slots[mid] < row)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < n_rows && row_slots[lo] == row) {
      slot = lo;
      slot_ok = true;
    }
  };
  for (auto& c : refs) {
    // bitmap containers are 65536 bits starting at a 65536-aligned
    // position: when rows are a multiple of 65536 bits wide (always
    // true for the 2^20 shard width) the whole container lands
    // word-aligned inside one row — OR-copy its 2048 words instead of
    // scattering up to 65536 single bits (dense planes: ~100x)
    if (c.type == kTypeBitmap && row_width % 65536 == 0) {
      if (c.data_len < 8192) return ERR_SHORT;
      uint64_t base = c.key << 16;
      lookup(base / row_width);
      if (!slot_ok) continue;
      size_t word0 = (size_t)((base % row_width) / 32);
      if (word0 + 2048 > words_per_row) return ERR_CAP;
      uint32_t* dst = plane + slot * words_per_row + word0;
      for (size_t w = 0; w < 2048; w++) {
        uint32_t v = rd32(c.data + 4 * w);
        dst[w] |= v;
        set += __builtin_popcount(v);
      }
      continue;
    }
    int64_t m = expand_container(c, lows);
    if (m < 0) return m;
    uint64_t base = c.key << 16;
    for (int64_t i = 0; i < m; i++) {
      uint64_t p = base | lows[i];
      uint64_t bit = p % row_width;
      lookup(p / row_width);
      if (!slot_ok) continue;
      if (bit / 32 >= words_per_row) return ERR_CAP;
      plane[slot * words_per_row + bit / 32] |= 1u << (bit % 32);
      set++;
    }
  }
  return set;
}

// Expand a blob's rows straight into caller-chosen plane slots:
//   rows[i] (sorted ascending) maps to plane row slots[i] — slots need
//   NOT be contiguous or ordered, so callers write fragment rows
//   directly into their final position of a shared chunk buffer (no
//   tmp slab + reorder copy, the pre-r10 plane_rows overhead).  plane
//   holds plane_rows * words_per_row uint32 words; rows absent from
//   rows[] are skipped.  The bulk entry point behind
//   store/native.expand_rows_into (parallel plane build: ctypes
//   releases the GIL for the whole call).  Returns bits set.
int64_t rc_expand_rows_into(const uint8_t* buf, size_t len,
                            uint64_t row_width, const uint64_t* rows,
                            const uint64_t* slots, size_t n_rows,
                            uint32_t* plane, size_t words_per_row,
                            size_t plane_rows) {
  std::vector<ContainerRef> refs;
  int64_t n = parse_headers(buf, len, refs);
  if (n < 0) return n;
  for (size_t i = 0; i < n_rows; i++)
    if (slots[i] >= plane_rows) return ERR_CAP;
  uint16_t lows[65536];
  int64_t set = 0;
  size_t slot = 0;
  bool slot_ok = false;
  uint64_t slot_row = ~0ull;
  auto lookup = [&](uint64_t row) {
    if (row == slot_row) return;
    slot_row = row;
    slot_ok = false;
    size_t lo = 0, hi = n_rows;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (rows[mid] < row)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < n_rows && rows[lo] == row) {
      slot = (size_t)slots[lo];
      slot_ok = true;
    }
  };
  for (auto& c : refs) {
    // same word-aligned OR-copy fast path as rc_expand_plane: a warm
    // dense sidecar (serialize_dense image) is ALL bitmap containers,
    // so its expansion is a straight memcpy-speed pass
    if (c.type == kTypeBitmap && row_width % 65536 == 0) {
      if (c.data_len < 8192) return ERR_SHORT;
      uint64_t base = c.key << 16;
      lookup(base / row_width);
      if (!slot_ok) continue;
      size_t word0 = (size_t)((base % row_width) / 32);
      if (word0 + 2048 > words_per_row) return ERR_CAP;
      uint32_t* dst = plane + slot * words_per_row + word0;
      for (size_t w = 0; w < 2048; w++) {
        uint32_t v = rd32(c.data + 4 * w);
        dst[w] |= v;
        set += __builtin_popcount(v);
      }
      continue;
    }
    int64_t m = expand_container(c, lows);
    if (m < 0) return m;
    uint64_t base = c.key << 16;
    for (int64_t i = 0; i < m; i++) {
      uint64_t p = base | lows[i];
      uint64_t bit = p % row_width;
      lookup(p / row_width);
      if (!slot_ok) continue;
      if (bit / 32 >= words_per_row) return ERR_CAP;
      plane[slot * words_per_row + bit / 32] |= 1u << (bit % 32);
      set++;
    }
  }
  return set;
}

// Serialized size upper bound for n positions (exact header + worst-case
// container payloads).
int64_t rc_serialized_bound(const uint64_t* positions, size_t n) {
  // worst case: every container is a full array: 12 + 4 header bytes
  // per container + 2 bytes per value; containers <= n
  return 8 + (int64_t)n * (12 + 4 + 2) + 16;
}

// positions (sorted unique) -> pilosa-format blob. Returns bytes written.
int64_t rc_serialize(const uint64_t* positions, size_t n, uint8_t* out,
                     size_t cap) {
  for (size_t i = 1; i < n; i++)
    if (positions[i] <= positions[i - 1]) return ERR_ORDER;
  // group by high 48 bits
  struct Cont {
    uint64_t key;
    size_t begin, end;  // slice of positions
    int type;
    uint32_t payload_len;
    uint16_t nruns;
  };
  std::vector<Cont> conts;
  size_t i = 0;
  while (i < n) {
    uint64_t key = positions[i] >> 16;
    size_t j = i;
    while (j < n && (positions[j] >> 16) == key) j++;
    conts.push_back({key, i, j, 0, 0, 0});
    i = j;
  }
  // choose container types
  for (auto& c : conts) {
    size_t card = c.end - c.begin;
    uint32_t nruns = 1;
    for (size_t k = c.begin + 1; k < c.end; k++)
      if ((positions[k] & 0xFFFF) != (positions[k - 1] & 0xFFFF) + 1) nruns++;
    uint32_t run_bytes = 2 + 4 * nruns;
    uint32_t array_bytes = (uint32_t)(2 * card);
    if (run_bytes < array_bytes && run_bytes < 8192) {
      c.type = kTypeRun;
      c.payload_len = run_bytes;
      c.nruns = (uint16_t)nruns;
    } else if (card <= kArrayMax) {
      c.type = kTypeArray;
      c.payload_len = array_bytes;
    } else {
      c.type = kTypeBitmap;
      c.payload_len = 8192;
    }
  }
  size_t need = 8 + conts.size() * 16;
  for (auto& c : conts) need += c.payload_len;
  if (need > cap) return ERR_CAP;

  wr16(out, kMagic);
  wr16(out + 2, kVersion);
  wr32(out + 4, (uint32_t)conts.size());
  size_t pos = 8;
  for (auto& c : conts) {
    wr64(out + pos, c.key);
    wr16(out + pos + 8, (uint16_t)c.type);
    wr16(out + pos + 10, (uint16_t)(c.end - c.begin - 1));
    pos += 12;
  }
  uint32_t off = (uint32_t)(pos + 4 * conts.size());
  for (auto& c : conts) {
    wr32(out + pos, off);
    pos += 4;
    off += c.payload_len;
  }
  for (auto& c : conts) {
    switch (c.type) {
      case kTypeArray:
        for (size_t k = c.begin; k < c.end; k++) {
          wr16(out + pos, (uint16_t)(positions[k] & 0xFFFF));
          pos += 2;
        }
        break;
      case kTypeBitmap: {
        std::memset(out + pos, 0, 8192);
        for (size_t k = c.begin; k < c.end; k++) {
          uint32_t low = positions[k] & 0xFFFF;
          out[pos + low / 8] |= (uint8_t)(1u << (low % 8));
        }
        pos += 8192;
        break;
      }
      case kTypeRun: {
        wr16(out + pos, c.nruns);
        pos += 2;
        uint16_t start = (uint16_t)(positions[c.begin] & 0xFFFF);
        uint16_t prev = start;
        for (size_t k = c.begin + 1; k < c.end; k++) {
          uint16_t v = (uint16_t)(positions[k] & 0xFFFF);
          if (v != prev + 1) {
            wr16(out + pos, start);
            wr16(out + pos + 2, prev);
            pos += 4;
            start = v;
          }
          prev = v;
        }
        wr16(out + pos, start);
        wr16(out + pos + 2, prev);
        pos += 4;
        break;
      }
    }
  }
  return (int64_t)pos;
}

// Pack sorted-or-not column offsets into little-endian uint32 words.
int64_t rc_pack_columns(const uint32_t* cols, size_t n, uint32_t* words,
                        size_t n_words) {
  for (size_t k = 0; k < n; k++) {
    uint32_t c = cols[k];
    if (c / 32 >= n_words) return ERR_CAP;
    words[c / 32] |= 1u << (c % 32);
  }
  return (int64_t)n;
}

// Popcount over packed words (host fallback oracle).
int64_t rc_popcount(const uint32_t* words, size_t n) {
  int64_t total = 0;
  for (size_t k = 0; k < n; k++) total += __builtin_popcount(words[k]);
  return total;
}

}  // extern "C"

extern "C" {

// Union of two sorted-unique uint32 arrays -> sorted-unique out.
// out capacity must be >= n + m.  Returns merged length.
// (RowBits.add hot path: numpy's union1d re-sorts; this is the linear
// merge for the already-sorted case.)
int64_t rc_union_u32(const uint32_t* a, size_t n, const uint32_t* b,
                     size_t m, uint32_t* out) {
  size_t i = 0, j = 0, k = 0;
  while (i < n && j < m) {
    uint32_t va = a[i], vb = b[j];
    if (va < vb) {
      out[k++] = va;
      i++;
    } else if (vb < va) {
      out[k++] = vb;
      j++;
    } else {
      out[k++] = va;
      i++;
      j++;
    }
  }
  while (i < n) out[k++] = a[i++];
  while (j < m) out[k++] = b[j++];
  return (int64_t)k;
}

// Difference a \ b of sorted-unique uint32 arrays. Returns out length.
int64_t rc_diff_u32(const uint32_t* a, size_t n, const uint32_t* b,
                    size_t m, uint32_t* out) {
  size_t i = 0, j = 0, k = 0;
  while (i < n && j < m) {
    if (a[i] < b[j]) {
      out[k++] = a[i++];
    } else if (b[j] < a[i]) {
      j++;
    } else {
      i++;
      j++;
    }
  }
  while (i < n) out[k++] = a[i++];
  return (int64_t)k;
}

}  // extern "C"
