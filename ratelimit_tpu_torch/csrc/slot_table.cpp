// The port's native slot table: cache-key -> device-slot assignment on
// the serving hot path.
//
// Same contract, answers and extern "C" ABI as the JAX package's
// native/slot_table.cpp (exact key->slot mapping, evict-soonest-
// expiring when full, batch pinning so two live keys in one device
// batch never share a slot, one ctypes call a batch, the fused assign +
// dedup of sk_assign_dedup_batch, the seeded flat key map).  It differs
// in the expiry index and the sweep that reads it:
//
// - Expiry index.  native/slot_table.cpp pushes a heap item that owns
//   a copy of the key for every insert; a sweep pops them one at a
//   time, a string compare a sift level, and finds each key in the map
//   again.  Here every expiry owns a bucket of 8-byte records {slot,
//   generation}.  A slot's generation goes up whenever its entry is
//   erased, so a record whose generation no longer matches is stale:
//   the heap's lazy deletion, without a key compare.  The map keeps
//   slot -> index, so a record reaches its key in the arena.
// - Order.  gc frees expired keys in the heap's exact order, expiry
//   ascending, then key bytes ascending: it walks the expired buckets
//   in expiry order and sorts each one's live records by key (the 16
//   bytes past the bucket's common prefix as two words, radix-sorted
//   from 8192 records up, the rest of the key on a tie).  free_slots is LIFO, so later keys get the slots
//   the heap would give them.  evict_one evicts the least (expiry, key) live,
//   unpinned entry: the first time it reads a bucket it sorts it,
//   keeps a cursor into it, and keeps keys inserted after that in a
//   small heap of key copies.
// - Erase shifts the rest of the probe run back (no tombstones), and a
//   sweep compacts the key arena once half of it is dead, so the next
//   insert neither rehashes nor copies.
// - Import sizes the map once for the entries it is given, so a restore
//   of n keys does not double its way up from 1024 entries.
// - Counters (sk_stats): assign lookups and the map cells their probes
//   examined (summed in a local over one batch call and added once),
//   rehashes past construction and their nanoseconds, and the bytes of
//   the host index.
//
// Slots are 32-bit in the records: a table holds fewer than 2^32.
//
// Build: compiled into the port's library by way of csrc/slot_release.cpp
// (backends/native_slot_table.py: g++ -O2 -std=c++20 -shared -fPIC).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <map>
#include <numeric>
#include <random>
#include <string>
#include <string_view>
#include <utility>
#include <vector>

namespace {

// Word-stride mix hash with a per-table random seed (blocks offline
// collision construction against externally controlled descriptor
// values).  8 bytes per iteration: a byte-at-a-time FNV measured ~50%
// SLOWER end-to-end on the ~30-byte serving keys.
inline uint64_t hash_key(uint64_t seed, std::string_view s) {
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(s.data());
  size_t n = s.size();
  uint64_t h = seed ^ (uint64_t(n) * 0x9e3779b97f4a7c15ull);
  while (n >= 8) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    k *= 0x9ddfea08eb382d69ull;
    k ^= k >> 29;
    h = (h ^ k) * 0x9e3779b97f4a7c15ull;
    p += 8;
    n -= 8;
  }
  if (n) {
    uint64_t k = 0;
    std::memcpy(&k, p, n);
    h = (h ^ k) * 0x9e3779b97f4a7c15ull;
  }
  // Final mix so linear probing sees high-entropy low bits.
  h ^= h >> 32;
  h *= 0xd6e8feb86659fd93ull;
  h ^= h >> 32;
  return h;
}

// One record of the expiry index: the slot an entry was inserted into
// and the slot's generation then.
struct Rec {
  uint32_t slot;
  uint32_t gen;
};

// Open-addressing key -> (slot, expiry) map.  States: EMPTY, FULL.
// Erases shift the probe run back and leave their arena bytes dead
// until compact_arena.  Per slot it keeps where the slot's entry sits
// and the slot's generation (erases so far).
class FlatMap {
 public:
  FlatMap(uint64_t seed, size_t num_slots, size_t initial_pow2 = 1024)
      : seed_(seed), homes_(num_slots) {
    rehash(initial_pow2, /*counted=*/false);
  }

  uint64_t hash_of(std::string_view key) const {
    return hash_key(seed_, key);
  }

  // Index of `key`, or -1.
  int64_t find(std::string_view key) const {
    uint64_t probes = 0;
    return find_hashed(hash_of(key), key, probes);
  }

  // Index of `key`, or -1; adds the cells examined to `probes`.
  int64_t find_hashed(uint64_t h, std::string_view key, uint64_t& probes) const {
    size_t i = h & mask_;
    while (true) {
      ++probes;
      const uint8_t st = state_[i];
      if (st == kEmpty) return -1;
      if (st == kFull && hashes_[i] == h) {
        const Meta& m = meta_[i];
        if (m.key_len == key.size() &&
            std::memcmp(arena_.data() + m.key_off, key.data(),
                        key.size()) == 0)
          return static_cast<int64_t>(i);
      }
      i = (i + 1) & mask_;
    }
  }

  // Insert a key known to be absent.
  void insert(std::string_view key, int64_t slot, int64_t expiry) {
    insert_hashed(hash_of(key), key, slot, expiry);
  }

  void insert_hashed(uint64_t h, std::string_view key, int64_t slot,
                     int64_t expiry) {
    // Grow at 70 % load.  Dead arena bytes (erases since the last
    // compaction) are dropped once they are half the arena; a sweep
    // does it first, so this catches releases and evictions.
    if ((live_ + 1) * 10 >= capacity() * 7) {
      rehash(capacity() * 2);
    } else if (arena_mostly_dead()) {
      compact_arena();
    }
    size_t i = h & mask_;
    while (state_[i] == kFull) i = (i + 1) & mask_;
    place(i, h,
          Meta{static_cast<uint64_t>(arena_.size()),
               static_cast<uint32_t>(key.size()), slot, expiry});
    arena_.append(key.data(), key.size());
    ++live_;
  }

  // Erase the entry at `idx` and bump its slot's generation.  Later
  // entries of the probe run move back into the hole where their home
  // allows (linear probing's backward-shift delete), so no tombstone
  // is left behind.
  void erase(int64_t idx) {
    size_t i = static_cast<size_t>(idx);
    ++homes_[meta_[i].slot].gen;
    dead_bytes_ += meta_[i].key_len;
    --live_;
    for (size_t j = (i + 1) & mask_; state_[j] == kFull; j = (j + 1) & mask_) {
      // Entry j may fill hole i only if i lies on its probe path,
      // from its home up to j.
      const size_t home = hashes_[j] & mask_;
      if (((j - home) & mask_) < ((j - i) & mask_)) continue;
      place(i, hashes_[j], meta_[j]);
      i = j;
    }
    state_[i] = kEmpty;
  }

  // Room for `n` entries without growing past 70 % load, and
  // `key_bytes` of keys in the arena.
  void reserve(size_t n, size_t key_bytes) {
    size_t cap = capacity();
    while (n * 10 >= cap * 7) cap <<= 1;
    if (cap > capacity()) rehash(cap);
    arena_.reserve(arena_.size() + key_bytes);
  }

  int64_t slot(int64_t idx) const { return meta_[idx].slot; }
  int64_t expiry(int64_t idx) const { return meta_[idx].expiry; }
  size_t size() const { return live_; }
  size_t arena_bytes() const { return arena_.size(); }
  uint64_t rehashes() const { return rehashes_; }
  uint64_t rehash_ns() const { return rehash_ns_; }
  // Bytes held: the map's three arrays, the arena, the slot homes.
  size_t map_bytes() const {
    return state_.capacity() + hashes_.capacity() * sizeof(uint64_t) +
           meta_.capacity() * sizeof(Meta);
  }
  size_t arena_capacity() const { return arena_.capacity(); }
  size_t homes_bytes() const { return homes_.capacity() * sizeof(Home); }

  // Index of the entry that holds `slot` (which must be held).
  int64_t index_of(uint32_t slot) const { return homes_[slot].idx; }
  uint32_t gen(uint32_t slot) const { return homes_[slot].gen; }
  void bump_gen(uint32_t slot) { ++homes_[slot].gen; }
  // The record's entry is still in the map.
  bool live(Rec r) const { return homes_[r.slot].gen == r.gen; }
  const void* home_addr(uint32_t slot) const { return &homes_[slot]; }
  const void* meta_addr(int64_t idx) const { return &meta_[idx]; }
  void prefetch_entry(uint32_t slot) const {
    const uint32_t i = homes_[slot].idx;
    __builtin_prefetch(&state_[i]);
    __builtin_prefetch(&hashes_[i]);
    __builtin_prefetch(&meta_[i]);
  }

  std::string_view key_at(int64_t idx) const {
    const Meta& m = meta_[idx];
    return {arena_.data() + m.key_off, m.key_len};
  }

  bool arena_mostly_dead() const {
    return dead_bytes_ > (1u << 20) && dead_bytes_ * 2 > arena_.size();
  }

  // Copy the live keys into a fresh arena, in index order.
  void compact_arena() {
    std::string fresh;
    fresh.reserve(arena_.size() - dead_bytes_);
    for (size_t i = 0; i < capacity(); ++i) {
      if (state_[i] != kFull) continue;
      Meta& m = meta_[i];
      const uint64_t off = fresh.size();
      fresh.append(arena_.data() + m.key_off, m.key_len);
      m.key_off = off;
    }
    arena_ = std::move(fresh);
    dead_bytes_ = 0;
  }

  template <class F>
  void for_each(F f) const {
    for (size_t i = 0; i < capacity(); ++i)
      if (state_[i] == kFull)
        f(key_at(static_cast<int64_t>(i)), meta_[i].slot, meta_[i].expiry);
  }

 private:
  static constexpr uint8_t kEmpty = 0, kFull = 1;
  struct Meta {
    // 64-bit offset: a u32 offset would silently wrap once ~4 GiB of
    // key bytes accumulate in the arena (dead keys included before
    // compaction), aliasing key comparisons onto wrong bytes.
    uint64_t key_off;
    uint32_t key_len;
    int64_t slot;
    int64_t expiry;
  };
  struct Home {
    uint32_t idx;  // where the slot's entry sits, while it has one
    uint32_t gen;  // erases of the slot's entries so far
  };

  size_t capacity() const { return state_.size(); }

  void place(size_t i, uint64_t h, const Meta& m) {
    state_[i] = kFull;
    hashes_[i] = h;
    meta_[i] = m;
    homes_[m.slot].idx = static_cast<uint32_t>(i);
  }

  // `counted`: every rehash but the constructor's.
  void rehash(size_t new_cap, bool counted = true) {
    const auto t0 = std::chrono::steady_clock::now();
    // Round up to a power of two >= max(new_cap, live*2, 1024).
    size_t want = std::max<size_t>(
        {new_cap, live_ * 2, static_cast<size_t>(1024)});
    size_t cap = 1024;
    while (cap < want) cap <<= 1;

    std::vector<uint8_t> old_state = std::move(state_);
    std::vector<uint64_t> old_hashes = std::move(hashes_);
    std::vector<Meta> old_meta = std::move(meta_);
    std::string old_arena = std::move(arena_);

    state_.assign(cap, kEmpty);
    hashes_.assign(cap, 0);
    meta_.assign(cap, Meta{});
    arena_.clear();
    arena_.reserve(old_arena.size());
    mask_ = cap - 1;
    live_ = 0;
    dead_bytes_ = 0;

    for (size_t i = 0; i < old_state.size(); ++i) {
      if (old_state[i] != kFull) continue;
      const Meta& m = old_meta[i];
      insert({old_arena.data() + m.key_off, m.key_len}, m.slot, m.expiry);
    }
    if (counted) {
      ++rehashes_;
      rehash_ns_ += static_cast<uint64_t>(
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - t0).count());
    }
  }

  uint64_t seed_;
  size_t mask_ = 0;
  size_t live_ = 0;
  size_t dead_bytes_ = 0;  // arena bytes owned by erased keys
  uint64_t rehashes_ = 0, rehash_ns_ = 0;
  std::vector<uint8_t> state_;
  std::vector<uint64_t> hashes_;
  std::vector<Meta> meta_;
  std::string arena_;
  std::vector<Home> homes_;  // by slot
};

// A record that evict_one keeps beside a sorted bucket, with a copy of
// its key: the order of a heap must not change under it when the
// entry goes and its slot takes another key.
struct LateRec {
  std::string key;
  Rec rec;
  bool operator>(const LateRec& o) const { return key > o.key; }
};

// The records of one expiry.  Until evict_one first reads the bucket,
// `recs` is in insertion order.  From then on (`sorted`), recs[head..]
// is in key order as of that read, and later inserts go to `late`, a
// min-heap by key.
struct Bucket {
  std::vector<Rec> recs;
  std::vector<LateRec> late;
  size_t head = 0;
  bool sorted = false;
};

// A live record while its bucket is put in key order: the 16 key bytes
// past the bucket's common prefix as two big-endian words, then the key.
struct KeyItem {
  uint64_t hi, lo;
  const char* key;
  uint32_t len;
  uint32_t slot;
};

// The key's 8 bytes from `off`, big-endian, zero past its end: word
// order is then byte order, and a key that ends sorts first.
inline uint64_t word_at(const KeyItem& it, size_t off) {
  if (off >= it.len) return 0;
  const size_t n = it.len - off;
  if (n >= 8) {
    uint64_t v;
    std::memcpy(&v, it.key + off, 8);
    return __builtin_bswap64(v);
  }
  uint64_t v = 0;
  for (size_t b = 0; b < n; ++b)
    v |= uint64_t(static_cast<unsigned char>(it.key[off + b])) << (56 - 8 * b);
  return v;
}

// Length of the common prefix of `a` and `b`, at most `limit`.
inline size_t common_prefix(std::string_view a, std::string_view b, size_t limit) {
  limit = std::min({limit, a.size(), b.size()});
  size_t i = 0;
  while (i < limit && a[i] == b[i]) ++i;
  return i;
}

struct SlotTable {
  int64_t num_slots;
  FlatMap map;  // key -> (slot, expiry)
  std::vector<int64_t> free_slots;  // LIFO, matches python list.pop()
  std::map<int64_t, Bucket> buckets;  // expiry -> its entries' records
  int64_t evictions = 0;
  // Assign lookups and the map cells their probes examined.
  uint64_t lookups = 0, probes = 0;
  // Pins are slot ids ("this slot was handed out in the in-flight
  // batch"), epoch-stamped: pin_stamp[slot] == pin_epoch means
  // pinned.  A fresh epoch per assign call (or per begin_batch for
  // the cross-call protocol) replaces clearing a set — and per-lane
  // pinning becomes one array store instead of an unordered_set
  // insert.
  bool batch_active = false;
  std::vector<uint32_t> pin_stamp;
  uint32_t pin_epoch = 0;

  // slot -> group-id scratch for the fused dedup, epoch-stamped so
  // no per-call clearing: stamp[slot] == dedup_epoch marks a live gid.
  std::vector<int32_t> gid_by_slot;
  std::vector<uint32_t> gid_stamp;
  uint32_t dedup_epoch = 0;

  // The sweep's scratch, kept for its capacity.
  std::vector<KeyItem> items, spare;
  std::vector<uint32_t> counts;

  explicit SlotTable(int64_t n)
      : num_slots(n),
        map(std::random_device{}() | (uint64_t(std::random_device{}()) << 32),
            static_cast<size_t>(n)) {
    free_slots.reserve(n);
    for (int64_t s = 0; s < n; ++s) free_slots.push_back(n - 1 - s);
    pin_stamp.assign(n, 0);
    gid_by_slot.assign(n, 0);
    gid_stamp.assign(n, 0);
  }

  // u32 wrap: stamp 0 must never alias a live epoch.
  static void bump_epoch(std::vector<uint32_t>& stamps, uint32_t& epoch) {
    if (++epoch == 0) {
      std::fill(stamps.begin(), stamps.end(), 0);
      epoch = 1;
    }
  }

  void next_pin_epoch() { bump_epoch(pin_stamp, pin_epoch); }

  // Start a new local pin scope unless a cross-call batch holds one.
  void begin_call_pins() {
    if (!batch_active) next_pin_epoch();
  }

  void pin(int64_t slot) { pin_stamp[slot] = pin_epoch; }
  bool is_pinned(int64_t slot) const {
    return pin_stamp[slot] == pin_epoch;
  }

  std::string_view key_of(Rec r) const {
    return map.key_at(map.index_of(r.slot));
  }

  // Free the slot and erase its entry (the slot's records go stale).
  void free_entry(uint32_t slot) {
    free_slots.push_back(slot);
    map.erase(map.index_of(slot));
  }

  // Record an entry just inserted with `expiry` into `slot`.
  void index_entry(int64_t expiry, int64_t slot) {
    Bucket& b = buckets[expiry];
    const Rec r{static_cast<uint32_t>(slot),
                map.gen(static_cast<uint32_t>(slot))};
    if (!b.sorted) {
      b.recs.push_back(r);
    } else {
      b.late.push_back(LateRec{std::string(key_of(r)), r});
      std::push_heap(b.late.begin(), b.late.end(), std::greater<LateRec>());
    }
  }

  // The live records of `b` (stale ones dropped) into `items`, in key
  // order.  A record's slot home, its entry and its key bytes are each
  // a miss at table size, so the walk prefetches them 24, 16 and 8
  // records ahead.
  void live_in_key_order(const Bucket& b) {
    items.clear();
    const size_t n = b.recs.size() - b.head;
    const size_t total = n + b.late.size();
    items.reserve(total);
    const auto rec = [&](size_t k) {
      return k < n ? b.recs[b.head + k] : b.late[k - n].rec;
    };
    // The keys' common prefix (a window's keys share their domain and
    // descriptor): the first live key's, shortened by each later key
    // that differs inside it.  The words of the items pushed before
    // the last shortening are read again after the walk (usually just
    // the first item).
    std::string_view first;
    size_t cp = 0, stale = 0;
    constexpr size_t kAhead = 8;
    for (size_t k = 0; k < total; ++k) {
      if (k + 3 * kAhead < total) __builtin_prefetch(map.home_addr(rec(k + 3 * kAhead).slot));
      if (k + 2 * kAhead < total) {
        const Rec r = rec(k + 2 * kAhead);
        if (map.live(r)) __builtin_prefetch(map.meta_addr(map.index_of(r.slot)));
      }
      if (k + kAhead < total) {
        const Rec r = rec(k + kAhead);
        if (map.live(r)) {
          const std::string_view key = key_of(r);
          __builtin_prefetch(key.data());
          __builtin_prefetch(key.data() + key.size() - 1);
        }
      }
      const Rec r = rec(k);
      if (!map.live(r)) continue;
      const std::string_view key = key_of(r);
      if (first.data() == nullptr) {
        first = key;
        cp = key.size();
      } else if (key.size() < cp || std::memcmp(key.data(), first.data(), cp) != 0) {
        cp = common_prefix(first, key, cp);
        stale = items.size();
      }
      KeyItem it{0, 0, key.data(), static_cast<uint32_t>(key.size()), r.slot};
      it.hi = word_at(it, cp);
      it.lo = word_at(it, cp + 8);
      items.push_back(it);
    }
    for (size_t k = 0; k < stale; ++k) {
      items[k].hi = word_at(items[k], cp);
      items[k].lo = word_at(items[k], cp + 8);
    }
    sort_items(cp);
  }

  // Key order of two items whose keys share `cp` bytes: the words,
  // then the bytes past the prefix.
  static auto key_less(size_t cp) {
    return [cp](const KeyItem& a, const KeyItem& b) {
      if (a.hi != b.hi) return a.hi < b.hi;
      if (a.lo != b.lo) return a.lo < b.lo;
      return std::string_view(a.key + cp, a.len - cp) <
             std::string_view(b.key + cp, b.len - cp);
    };
  }

  // Below this many items the comparison sort is as fast or faster:
  // the radix sort's fixed cost (2 MiB of digit counts to clear and up
  // to eight 64k-entry prefix sums) is ~0.2-0.4 ms.  On the 8-core host
  // of an H100 machine (g++ 13.3, per-IP keys of one window) both take
  // ~0.7 ms at 8192 items; the radix sort takes 0.9 against 1.1 ms at
  // 12288, and 9 against 19 ms at 160000.
  static constexpr size_t kRadixMin = 8192;

  // Sort `items` by key.
  void sort_items(size_t cp) {
    if (items.size() < kRadixMin) {
      std::sort(items.begin(), items.end(), key_less(cp));
    } else {
      radix_sort_items(cp);
    }
  }

  // A radix sort by (`hi`, `lo`), 16 bits a pass from the last (a pass
  // whose digit is the same in every item is skipped), then each run
  // of equal words by the key's bytes past the common prefix `cp`.
  void radix_sort_items(size_t cp) {
    const size_t n = items.size();
    if (n < 2) return;
    constexpr size_t kDigits = 1 << 16;
    // Digit d: bits 16 * (d % 4) of lo for d < 4, of hi after.
    const auto digit = [](const KeyItem& it, int d) {
      return static_cast<size_t>(((d < 4 ? it.lo : it.hi) >> (16 * (d % 4))) & 0xffff);
    };
    counts.assign(8 * kDigits, 0);
    for (const KeyItem& it : items)
      for (int d = 0; d < 8; ++d) ++counts[d * kDigits + digit(it, d)];
    spare.resize(n);
    for (int d = 0; d < 8; ++d) {
      uint32_t* c = counts.data() + d * kDigits;
      if (c[digit(items[0], d)] == n) continue;
      uint32_t sum = 0;
      for (size_t v = 0; v < kDigits; ++v) {
        const uint32_t k = c[v];
        c[v] = sum;
        sum += k;
      }
      for (const KeyItem& it : items) spare[c[digit(it, d)]++] = it;
      items.swap(spare);
    }
    const auto less = key_less(cp);
    for (size_t a = 0; a < n;) {
      size_t b = a + 1;
      while (b < n && items[b].hi == items[a].hi && items[b].lo == items[a].lo) ++b;
      if (b - a > 1) std::sort(items.begin() + a, items.begin() + b, less);
      a = b;
    }
  }

  // Sort `b` for evict_one: live records in key order from head 0.
  void sort_bucket(Bucket& b) {
    live_in_key_order(b);
    b.recs.clear();
    for (const KeyItem& it : items) b.recs.push_back(Rec{it.slot, map.gen(it.slot)});
    b.late.clear();
    b.head = 0;
    b.sorted = true;
  }

  // Free every expired entry, expiry ascending, then key ascending.
  // Pinned slots (handed out in the in-flight batch) stay in their
  // bucket: reclaiming one mid-batch would alias two live keys in one
  // device step (same rule as evict_one).
  int64_t gc(int64_t now, bool use_pins) {
    int64_t freed = 0;
    for (auto it = buckets.begin(); it != buckets.end() && it->first <= now;) {
      Bucket& b = it->second;
      live_in_key_order(b);
      std::vector<Rec> kept;
      for (size_t k = 0; k < items.size(); ++k) {
        if (k + 16 < items.size()) __builtin_prefetch(map.home_addr(items[k + 16].slot));
        if (k + 8 < items.size()) map.prefetch_entry(items[k + 8].slot);
        const uint32_t slot = items[k].slot;
        if (use_pins && is_pinned(slot)) {
          kept.push_back(Rec{slot, map.gen(slot)});
          continue;
        }
        free_entry(slot);
        ++freed;
      }
      if (kept.empty()) {
        it = buckets.erase(it);
      } else {
        b.recs = std::move(kept);
        b.late.clear();
        b.head = 0;
        b.sorted = false;
        ++it;
      }
    }
    if (map.arena_mostly_dead()) map.compact_arena();
    return freed;
  }

  // Evict the least (expiry, key) live, unpinned entry.  Returns false
  // when the table is exhausted (batch pins more live keys than slots).
  bool evict_one() {
    for (auto it = buckets.begin(); it != buckets.end();) {
      Bucket& b = it->second;
      if (!b.sorted) sort_bucket(b);
      while (b.head < b.recs.size() && !map.live(b.recs[b.head])) ++b.head;
      size_t j = b.head;
      while (j < b.recs.size() &&
             (!map.live(b.recs[j]) || is_pinned(b.recs[j].slot)))
        ++j;
      std::vector<LateRec> held;  // pinned, set aside from the heap top
      while (!b.late.empty()) {
        const Rec top = b.late.front().rec;
        if (map.live(top) && !is_pinned(top.slot)) break;
        std::pop_heap(b.late.begin(), b.late.end(), std::greater<LateRec>());
        if (map.live(top)) held.push_back(std::move(b.late.back()));
        b.late.pop_back();
      }
      int64_t victim = -1;
      if (j < b.recs.size()) victim = b.recs[j].slot;
      if (!b.late.empty() &&
          (victim < 0 ||
           std::string_view(b.late.front().key) < key_of(b.recs[j])))
        victim = b.late.front().rec.slot;
      if (victim >= 0) free_entry(static_cast<uint32_t>(victim));
      for (LateRec& h : held) {
        b.late.push_back(std::move(h));
        std::push_heap(b.late.begin(), b.late.end(), std::greater<LateRec>());
      }
      if (victim >= 0) {
        ++evictions;
        return true;
      }
      if (b.head == b.recs.size() && b.late.empty()) {
        it = buckets.erase(it);
      } else {
        ++it;
      }
    }
    return false;
  }

  // Bytes of the expiry index: the buckets' records and late heaps.
  size_t expiry_bytes() const {
    size_t bytes = 0;
    for (const auto& [expiry, b] : buckets) {
      bytes += sizeof(std::pair<const int64_t, Bucket>) + b.recs.capacity() * sizeof(Rec) +
               b.late.capacity() * sizeof(LateRec);
      for (const LateRec& r : b.late) bytes += r.key.capacity();
    }
    return bytes;
  }

  // Assign one key; returns (slot, fresh) via out params, false on
  // exhaustion.  `pinned` accumulates every slot handed out; `probes`
  // the map cells the lookup examined.
  bool assign_one(std::string_view key, int64_t now, int64_t expiry,
                  int64_t* out_slot, bool* out_fresh, uint64_t& probes) {
    const uint64_t h = map.hash_of(key);  // hashed once: find + insert
    int64_t idx = map.find_hashed(h, key, probes);
    if (idx >= 0) {
      *out_slot = map.slot(idx);
      *out_fresh = false;
      pin(*out_slot);
      return true;
    }
    if (free_slots.empty()) gc(now, /*use_pins=*/true);
    if (free_slots.empty() && !evict_one()) return false;
    int64_t slot = free_slots.back();
    free_slots.pop_back();
    map.insert_hashed(h, key, slot, expiry);
    index_entry(expiry, slot);
    pin(slot);
    *out_slot = slot;
    *out_fresh = true;
    return true;
  }
};

}  // namespace

extern "C" {

void* sk_create(int64_t num_slots) { return new SlotTable(num_slots); }

void sk_destroy(void* t) { delete static_cast<SlotTable*>(t); }

int64_t sk_len(void* t) {
  return static_cast<int64_t>(static_cast<SlotTable*>(t)->map.size());
}

int64_t sk_evictions(void* t) { return static_cast<SlotTable*>(t)->evictions; }

// Key-arena footprint (bytes), incl. not-yet-compacted dead keys — a
// live memory gauge and the churn-compaction test's probe.
int64_t sk_arena_bytes(void* t) {
  return static_cast<int64_t>(static_cast<SlotTable*>(t)->map.arena_bytes());
}

int64_t sk_gc(void* tp, int64_t now) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  return t->gc(now, /*use_pins=*/t->batch_active);
}

// Assign a whole batch in one call.
//   key_blob / key_lens[n]: concatenated utf-8 keys
//   expiries[n]:            per-key expiry (ignored for known keys)
//   out_slots[n], out_fresh[n]
// Keys appearing twice in the batch get the same slot (second sight is
// not fresh).  All slots handed out in the batch are pinned against
// eviction until the call returns.  Returns 0 on success, -1 when the
// table is exhausted (more pinned live keys than slots).
int64_t sk_assign_batch(void* tp, const uint8_t* key_blob,
                        const int64_t* key_lens, int64_t n, int64_t now,
                        const int64_t* expiries, int64_t* out_slots,
                        uint8_t* out_fresh) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  t->begin_call_pins();
  const char* p = reinterpret_cast<const char*>(key_blob);
  uint64_t probes = 0;
  int64_t i = 0;
  for (; i < n; ++i) {
    std::string_view key(p, static_cast<size_t>(key_lens[i]));
    p += key_lens[i];
    int64_t slot;
    bool fresh;
    if (!t->assign_one(key, now, expiries[i], &slot, &fresh, probes)) break;
    out_slots[i] = slot;
    out_fresh[i] = fresh ? 1 : 0;
  }
  t->lookups += static_cast<uint64_t>(std::min(i + 1, n));
  t->probes += probes;
  return i == n ? 0 : -1;
}

// Fused assign + duplicate-slot aggregation (the C++ version of
// engine.py _dedup_chunk, folded into the assignment walk).
//
// Inputs as sk_assign_batch, plus per-lane hits[n] (uint32) and
// limits[n] (uint32).  Outputs (buffers sized n; only the first g
// group entries are written):
//   out_group[n]    lane -> group index, groups in ASCENDING SLOT
//                   order (matches np.unique's sorted order, which the
//                   sharded engine's bank routing relies on)
//   out_uniq[g]     sorted unique slots (int32)
//   out_totals[g]   per-group hit totals (uint64, unwrapped)
//   out_prefix[n]   per-lane exclusive same-group prefix of hits, in
//                   batch order (Redis pipeline-order semantics)
//   out_freshg[g]   group had a freshly-assigned slot
//   out_limitmax[g] max limit across the group's lanes
// Returns g (number of groups), or -1 on table exhaustion.
int64_t sk_assign_dedup_batch(void* tp, const uint8_t* key_blob,
                              const int64_t* key_lens, int64_t n, int64_t now,
                              const int64_t* expiries, const uint32_t* hits,
                              const uint32_t* limits, int32_t* out_group,
                              int32_t* out_uniq, uint64_t* out_totals,
                              uint64_t* out_prefix, uint8_t* out_freshg,
                              uint32_t* out_limitmax) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  t->begin_call_pins();

  // Epoch-stamped slot->gid scratch: O(1) array reads instead of a
  // per-call hash map (measured ~25% of the fused call).
  SlotTable::bump_epoch(t->gid_stamp, t->dedup_epoch);
  const uint32_t ep = t->dedup_epoch;
  std::vector<int64_t> g_slot;
  std::vector<uint64_t> g_total;
  std::vector<uint8_t> g_fresh;
  std::vector<uint32_t> g_limit;
  g_slot.reserve(n);
  g_total.reserve(n);
  g_fresh.reserve(n);
  g_limit.reserve(n);

  std::vector<int32_t> lane_gid(static_cast<size_t>(n));
  const char* p = reinterpret_cast<const char*>(key_blob);
  uint64_t probes = 0;
  for (int64_t i = 0; i < n; ++i) {
    std::string_view key(p, static_cast<size_t>(key_lens[i]));
    p += key_lens[i];
    int64_t slot;
    bool fresh;
    if (!t->assign_one(key, now, expiries[i], &slot, &fresh, probes)) {
      t->lookups += static_cast<uint64_t>(i + 1);
      t->probes += probes;
      return -1;
    }
    int32_t gid;
    if (t->gid_stamp[slot] == ep) {
      gid = t->gid_by_slot[slot];
    } else {
      gid = static_cast<int32_t>(g_slot.size());
      t->gid_stamp[slot] = ep;
      t->gid_by_slot[slot] = gid;
      g_slot.push_back(slot);
      g_total.push_back(0);
      g_fresh.push_back(0);
      g_limit.push_back(0);
    }
    out_prefix[i] = g_total[gid];
    g_total[gid] += hits[i];
    if (limits[i] > g_limit[gid]) g_limit[gid] = limits[i];
    if (fresh) g_fresh[gid] = 1;
    lane_gid[i] = gid;
  }

  t->lookups += static_cast<uint64_t>(n);
  t->probes += probes;

  // Sorted-slot group order (np.unique parity).
  const int32_t g = static_cast<int32_t>(g_slot.size());
  std::vector<int32_t> order(g);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return g_slot[a] < g_slot[b];
  });
  std::vector<int32_t> rank(g);
  for (int32_t k = 0; k < g; ++k) {
    rank[order[k]] = k;
    out_uniq[k] = static_cast<int32_t>(g_slot[order[k]]);
    out_totals[k] = g_total[order[k]];
    out_freshg[k] = g_fresh[order[k]];
    out_limitmax[k] = g_limit[order[k]];
  }
  for (int64_t i = 0; i < n; ++i) out_group[i] = rank[lane_gid[i]];
  return g;
}

void sk_begin_batch(void* tp) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  t->batch_active = true;
  t->next_pin_epoch();  // fresh cross-call pin scope
}

void sk_end_batch(void* tp) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  t->batch_active = false;
}

// Checkpoint export: call once with null buffers to get sizes, then
// with buffers of (total_key_bytes, n, n, n).
int64_t sk_export_size(void* tp, int64_t* out_total_key_bytes) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  int64_t bytes = 0;
  t->map.for_each([&](std::string_view key, int64_t, int64_t) {
    bytes += static_cast<int64_t>(key.size());
  });
  *out_total_key_bytes = bytes;
  return static_cast<int64_t>(t->map.size());
}

void sk_export(void* tp, uint8_t* key_blob, int64_t* key_lens,
               int64_t* slots, int64_t* expiries) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  uint8_t* p = key_blob;
  int64_t i = 0;
  t->map.for_each([&](std::string_view key, int64_t slot, int64_t expiry) {
    std::memcpy(p, key.data(), key.size());
    p += key.size();
    key_lens[i] = static_cast<int64_t>(key.size());
    slots[i] = slot;
    expiries[i] = expiry;
    ++i;
  });
}

// Checkpoint import: bulk-load entries into a fresh table.  Invalid or
// duplicate slots are skipped.  Returns how many entries were loaded.
// The map is sized for the n entries (and the arena for their bytes)
// before the first insert: at most one rehash, none past it.
int64_t sk_import(void* tp, const uint8_t* key_blob, const int64_t* key_lens,
                  const int64_t* slots, const int64_t* expiries, int64_t n) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  std::vector<uint8_t> used(t->num_slots, 0);
  size_t key_bytes = 0;
  for (int64_t i = 0; i < n; ++i) key_bytes += static_cast<size_t>(key_lens[i]);
  t->map.reserve(t->map.size() + static_cast<size_t>(std::max<int64_t>(n, 0)), key_bytes);
  const char* p = reinterpret_cast<const char*>(key_blob);
  int64_t loaded = 0;
  uint64_t probes = 0;  // import lookups are not assign lookups
  for (int64_t i = 0; i < n; ++i) {
    std::string_view key(p, static_cast<size_t>(key_lens[i]));
    p += key_lens[i];
    int64_t slot = slots[i];
    if (slot < 0 || slot >= t->num_slots || used[slot]) continue;
    // Duplicate keys in a snapshot would leak the slot (marked used,
    // but the insert would create a shadowed duplicate): keep the
    // first entry.
    const uint64_t h = t->map.hash_of(key);
    if (t->map.find_hashed(h, key, probes) >= 0) continue;
    used[slot] = 1;
    t->map.insert_hashed(h, key, slot, expiries[i]);
    t->index_entry(expiries[i], slot);
    ++loaded;
  }
  // The free list is rebuilt: a slot put on it starts a generation.
  t->free_slots.clear();
  for (int64_t s = t->num_slots - 1; s >= 0; --s) {
    if (used[s]) continue;
    t->free_slots.push_back(s);
    t->map.bump_gen(static_cast<uint32_t>(s));
  }
  return loaded;
}

// The table's counters and sizes, nine int64s into `out`: assign
// lookups, probe cells, rehashes past construction, their nanoseconds,
// the host index's bytes (the sum of the next four), the map's arrays,
// the key arena (capacity), the slot homes and the expiry index.
// Returns the number of fields written.
int64_t sk_stats(void* tp, int64_t* out) {
  const SlotTable* t = static_cast<const SlotTable*>(tp);
  const FlatMap& m = t->map;
  const size_t map_bytes = m.map_bytes(), arena = m.arena_capacity(),
               homes = m.homes_bytes(), expiry = t->expiry_bytes();
  const int64_t fields[] = {
      static_cast<int64_t>(t->lookups), static_cast<int64_t>(t->probes),
      static_cast<int64_t>(m.rehashes()), static_cast<int64_t>(m.rehash_ns()),
      static_cast<int64_t>(map_bytes + arena + homes + expiry),
      static_cast<int64_t>(map_bytes), static_cast<int64_t>(arena),
      static_cast<int64_t>(homes), static_cast<int64_t>(expiry),
  };
  constexpr int64_t n = sizeof(fields) / sizeof(fields[0]);
  std::memcpy(out, fields, sizeof(fields));
  return n;
}

}  // extern "C"
