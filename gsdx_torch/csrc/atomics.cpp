// Shared-memory atomic counter primitives for the lock-free camera IPC stack
// (the port's own copy of native/gsdx_atomics.cpp).
//
// Native replacement for the `atomics` C library the reference wraps
// (`src/real_world/camera/shared_memory/shared_memory_util.py:5,29-39`):
// 64-bit load/store/fetch-add with explicit ACQUIRE / RELEASE / ACQ_REL
// orderings over a caller-provided buffer (a multiprocessing SharedMemory
// mapping shared across processes).
//
// Built by g++ at first use into build/host/ (gsdx_torch/realworld/
// shared_memory.py `_load_native`) and loaded with ctypes. Host code: no
// CUDA, so the camera processes that use it never touch the card.

#include <atomic>
#include <cstdint>

static_assert(sizeof(std::atomic<uint64_t>) == sizeof(uint64_t),
              "atomic<u64> must be layout-compatible with u64");
static_assert(std::atomic<uint64_t>::is_always_lock_free,
              "u64 atomics must be lock-free for cross-process use");

static inline std::atomic<uint64_t>* as_atomic(void* p) {
  return reinterpret_cast<std::atomic<uint64_t>*>(p);
}

extern "C" {

uint64_t gsdx_atomic_load_acquire(void* p) {
  return as_atomic(p)->load(std::memory_order_acquire);
}

void gsdx_atomic_store_release(void* p, uint64_t v) {
  as_atomic(p)->store(v, std::memory_order_release);
}

uint64_t gsdx_atomic_fetch_add_acq_rel(void* p, uint64_t v) {
  return as_atomic(p)->fetch_add(v, std::memory_order_acq_rel);
}

uint64_t gsdx_atomic_exchange_acq_rel(void* p, uint64_t v) {
  return as_atomic(p)->exchange(v, std::memory_order_acq_rel);
}

// Compare-and-swap; returns 1 on success, 0 on failure; *expected is
// updated with the observed value on failure (std::atomic CAS semantics).
int gsdx_atomic_cas_acq_rel(void* p, uint64_t* expected, uint64_t desired) {
  return as_atomic(p)->compare_exchange_strong(
             *expected, desired, std::memory_order_acq_rel,
             std::memory_order_acquire)
             ? 1
             : 0;
}

}  // extern "C"
