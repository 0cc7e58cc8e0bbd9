// The clean fixture's one launcher.
extern "C" int rl_add(void* table, long long num_slots, const void* slots,
                      int n, void* stream) {
  return 0;
}
