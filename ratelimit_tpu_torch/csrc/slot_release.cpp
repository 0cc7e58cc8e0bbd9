// The port's native slot table (csrc/slot_table.cpp), compiled in this
// translation unit, plus the release a counter handoff's second leg
// needs (cluster/handoff.py, engine.release_keys).
//
// sk_release_batch drops each given (key, slot, expiry) that the table
// still holds exactly as given -- the same key in the same slot with
// the same expiry -- and frees its slot: one hash probe and one erase a
// key, no rebuild of the table.  A key that gc reclaimed, or whose slot
// went to another key, since the caller copied the table is left
// alone.  The expiry records of released keys go stale, as gc's do.
//
// Build: g++ -O2 -std=c++20 -shared -fPIC with native/decide.cpp
// (backends/native_slot_table.py).

#include "slot_table.cpp"

extern "C" {

int64_t sk_release_batch(void* tp, const uint8_t* key_blob,
                         const int64_t* key_lens, const int64_t* slots,
                         const int64_t* expiries, int64_t n,
                         uint8_t* out_released) {
  SlotTable* t = static_cast<SlotTable*>(tp);
  const char* p = reinterpret_cast<const char*>(key_blob);
  int64_t released = 0;
  for (int64_t i = 0; i < n; ++i) {
    std::string_view key(p, static_cast<size_t>(key_lens[i]));
    p += key_lens[i];
    const int64_t idx = t->map.find(key);
    const bool same = idx >= 0 && t->map.slot(idx) == slots[i] &&
                      t->map.expiry(idx) == expiries[i];
    if (same) {
      t->free_slots.push_back(slots[i]);
      t->map.erase(idx);
      ++released;
    }
    out_released[i] = same ? 1 : 0;
  }
  return released;
}

}  // extern "C"
