// Runs a CUDA kernel's body on the CPU, so that a test can check its
// indexing with g++ where there is no card: each CTA's threads run as
// std::threads, __syncthreads is a std::barrier (and __syncwarp one a
// warp), a TMA bulk copy or a cp.async is a plain copy, an mbarrier counts
// its arrivals and bytes as the card does, and mma.sync's TF32 product is
// exchanged between a warp's lanes as the PTX ISA lays out its fragments. It cannot
// see races between asynchronous copies and the threads, nor anything of
// the card's timing. Compile with -std=c++20 -pthread.

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
// a warp's barrier, and the fragments its lanes exchange in an mma
struct WarpMma {
  uint32_t a[32][4], b[32][2];
  float c[32][4];
};
inline thread_local std::barrier<>* warp_barrier = nullptr;
inline thread_local WarpMma* warp_mma = nullptr;
inline thread_local std::barrier<>* mma_barrier = nullptr;  // pivot_dw's MMA warps
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
    const int warps = (threads + 31) / 32;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    for (int w = 0; w < warps; ++w)
      warp_bars.emplace_back(new std::barrier<>(std::min(32, threads - 32 * w)));
    std::vector<WarpMma> mmas(warps);
    std::barrier<> mma_bar(std::min(threads, 384));
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        thread_idx = {(unsigned)t, 0, 0};
        block_idx = {(unsigned)b, 0, 0};
        cta_barrier = &bar;
        cta_smem = smem;
        warp_barrier = warp_bars[t / 32].get();
        warp_mma = &mmas[t / 32];
        mma_barrier = &mma_bar;
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
inline void __syncwarp(unsigned = 0xffffffffu) { fss_emu::warp_barrier->arrive_and_wait(); }

using std::max;
using std::min;

// pivot_dw's named barrier over its MMA warps, the CTA's first 384 threads
inline void mma_warps_sync() { fss_emu::mma_barrier->arrive_and_wait(); }

inline uint32_t __float_as_uint(float a) {
  uint32_t r;
  std::memcpy(&r, &a, 4);
  return r;
}
inline float __uint_as_float(uint32_t a) {
  float r;
  std::memcpy(&r, &a, 4);
  return r;
}

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
#define DW_CLOCK() 0LL
#define DW_PHASES_END(ph) \
  do {                    \
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
inline void mbar_arrive(unsigned long long* bar) {
  std::lock_guard<std::mutex> g(fss_emu::bar_mutex);
  fss_emu::Bar& b = fss_emu::bars.at(bar);
  --b.pending;
  fss_emu::bar_complete(b);
}
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

// cp.async of 4, 8 or 16 bytes is a plain copy here; its groups need no wait
inline void cp_async4(float* dst, const float* src) { std::memcpy(dst, src, 4); }
inline void cp_async8(float* dst, const float* src) { std::memcpy(dst, src, 8); }
inline void cp_async16(float* dst, const float* src) { std::memcpy(dst, src, 16); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

// cvt.rna.tf32.f32: to nearest, ties away from zero, on the magnitude.
inline uint32_t tf32_rna(float a) { return (__float_as_uint(a) + 0x1000u) & 0xffffe000u; }

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d = a . b + d, by the
// PTX ISA's fragments (grp = lane / 4, tig = lane % 4): a holds A[grp][tig],
// A[grp+8][tig], A[grp][tig+4], A[grp+8][tig+4]; b holds B[tig][grp],
// B[tig+4][grp]; d holds D[grp][2 tig], D[grp][2 tig+1], D[grp+8][2 tig],
// D[grp+8][2 tig+1]. Every lane of the warp must call it.
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  fss_emu::WarpMma& w = *fss_emu::warp_mma;
  const int lane = (int)(threadIdx.x & 31);
  for (int i = 0; i < 4; ++i) {
    w.a[lane][i] = a[i];
    w.c[lane][i] = d[i];
  }
  w.b[lane][0] = b[0];
  w.b[lane][1] = b[1];
  __syncwarp();
  const int grp = lane >> 2, tig = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = grp + (i >= 2 ? 8 : 0), n = 2 * tig + (i & 1);
    float acc = w.c[lane][i];
    for (int k = 0; k < 8; ++k)
      acc += __uint_as_float(w.a[(r % 8) * 4 + k % 4][(r >= 8) + 2 * (k >= 4)]) *
             __uint_as_float(w.b[n * 4 + k % 4][k >= 4]);
    out[i] = acc;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
