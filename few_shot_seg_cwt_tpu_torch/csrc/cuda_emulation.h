// Runs a CUDA kernel's body on the CPU, so that a test can check its
// indexing with g++ where there is no card: each CTA's threads run as
// std::threads, __syncthreads is a std::barrier, a TMA bulk copy is a plain
// copy, and an mbarrier counts its arrivals and bytes as the card does. It
// cannot see races between asynchronous copies and the threads, nor
// anything of the card's timing. Compile with -std=c++20 -pthread.

#pragma once

#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};

namespace fss_emu {
struct Dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local Dim3 thread_idx, block_idx;
inline Dim3 block_dim, grid_dim;
inline thread_local std::barrier<>* cta_barrier = nullptr;
inline thread_local float* cta_smem = nullptr;
inline void check_bars();

// Run body() as `blocks` CTAs of `threads` threads, one CTA after another,
// each with `smem_floats` of shared memory filled with NaN (a read of
// anything the kernel did not write shows in its output).
template <class F>
void launch(int blocks, int threads, size_t smem_floats, F body) {
  grid_dim = {(unsigned)blocks, 1, 1};
  block_dim = {(unsigned)threads, 1, 1};
  std::unique_ptr<float4[]> buf(new float4[smem_floats / 4 + 1]);
  float* smem = reinterpret_cast<float*>(buf.get());
  for (int b = 0; b < blocks; ++b) {
    std::fill(smem, smem + smem_floats, std::numeric_limits<float>::quiet_NaN());
    std::barrier<> bar(threads);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        thread_idx = {(unsigned)t, 0, 0};
        block_idx = {(unsigned)b, 0, 0};
        cta_barrier = &bar;
        cta_smem = smem;
        body();
      });
    for (auto& th : pool) th.join();
    check_bars();
  }
}
}  // namespace fss_emu

#define threadIdx (fss_emu::thread_idx)
#define blockIdx (fss_emu::block_idx)
#define blockDim (fss_emu::block_dim)
#define gridDim (fss_emu::grid_dim)
#define FSS_SHARED(name) float* name = fss_emu::cta_smem

inline void __syncthreads() { fss_emu::cta_barrier->arrive_and_wait(); }

// the card build's per-phase clocks are not emulated
#define FWD_PHASE_START() \
  do {                    \
  } while (0)
#define FWD_PHASE(i) \
  do {               \
  } while (0)
#define FWD_PHASE_END() \
  do {                  \
  } while (0)

using std::fmaf;
using std::fmaxf;

// mbarriers with a transaction count, kept beside the emulated shared
// memory by address: a phase completes when its arrivals are in and the
// bytes it expects have been copied. A wait that does not end within 10 s,
// or a launch that ends with bytes outstanding, aborts: the card would hang
// or race there.
namespace fss_emu {
struct Bar {
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
};
inline std::mutex bar_mutex;
inline std::map<const void*, Bar> bars;

inline void bar_complete(Bar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
  }
}
inline void check_bars() {
  for (auto& kv : bars)
    if (kv.second.tx != 0 || kv.second.pending != kv.second.count) {
      std::fprintf(stderr, "emulated mbarrier left %lld bytes, %d arrivals outstanding\n",
                   kv.second.tx, kv.second.pending);
      std::abort();
    }
  bars.clear();
}
}  // namespace fss_emu

inline void mbar_init(unsigned long long* bar, unsigned count) {
  std::lock_guard<std::mutex> g(fss_emu::bar_mutex);
  fss_emu::bars[bar] = {(int)count, (int)count, 0, 0};
}
inline void fence_mbar_init() {}
inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  std::lock_guard<std::mutex> g(fss_emu::bar_mutex);
  fss_emu::Bar& b = fss_emu::bars.at(bar);
  b.tx += bytes;
  --b.pending;
  fss_emu::bar_complete(b);
}
inline void bulk_copy_g2s(float* dst, const float* src, unsigned bytes, unsigned long long* bar) {
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> g(fss_emu::bar_mutex);
  fss_emu::Bar& b = fss_emu::bars.at(bar);
  b.tx -= bytes;
  fss_emu::bar_complete(b);
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  const auto until = std::chrono::steady_clock::now() + std::chrono::seconds(10);
  for (;;) {
    {
      std::lock_guard<std::mutex> g(fss_emu::bar_mutex);
      if (fss_emu::bars.at(bar).phase != parity) return;
    }
    if (std::chrono::steady_clock::now() > until) {
      std::fprintf(stderr, "emulated mbarrier wait timed out (a byte count is wrong)\n");
      std::abort();
    }
    std::this_thread::yield();
  }
}
inline void fence_proxy_async() {}
