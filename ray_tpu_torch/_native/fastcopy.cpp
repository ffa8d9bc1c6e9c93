// Native data-plane helpers for the shm object store.
//
// Reference parity: the role plasma's C++ store core plays on the CPU data
// path (src/ray/object_manager/plasma/ — dlmalloc arena + memcpy into shm).
// Here the store is mmap files, so the native piece is the hot copy loop:
// a multi-threaded memcpy that runs with the GIL released (ctypes releases
// it around foreign calls), turning single-core Python slice-assignment
// bandwidth into memory-bus bandwidth on real hosts.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread fastcopy.cpp
// (done lazily by ray_tpu/_native/__init__.py; no build system needed).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Plain copy, GIL-free via ctypes.
void rt_copy(char* dst, const char* src, uint64_t n) {
    std::memcpy(dst, src, n);
}

// Multi-threaded copy for large blobs. Threads each take one contiguous
// stripe; stripe size is rounded to 4 KiB so threads never share a page.
void rt_parallel_copy(char* dst, const char* src, uint64_t n,
                      int32_t nthreads) {
    if (nthreads <= 1 || n < (1u << 22)) {  // < 4 MiB: one memcpy wins
        std::memcpy(dst, src, n);
        return;
    }
    uint64_t stripe = (n + nthreads - 1) / nthreads;
    stripe = (stripe + 4095) & ~uint64_t(4095);
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < nthreads; ++t) {
        uint64_t off = uint64_t(t) * stripe;
        if (off >= n) break;
        uint64_t len = std::min(stripe, n - off);
        threads.emplace_back(
            [=] { std::memcpy(dst + off, src + off, len); });
    }
    for (auto& th : threads) th.join();
}

// FNV-1a — cheap integrity probe for transfers (not cryptographic).
uint64_t rt_fnv1a(const char* data, uint64_t n) {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t i = 0; i < n; ++i) {
        h ^= (unsigned char)data[i];
        h *= 1099511628211ull;
    }
    return h;
}

}  // extern "C"
