// pivot_fwd_kernel (pivot_fwd.cuh) run on the CPU through cuda_emulation.h,
// and the per-output chain it must reproduce, as a shared library for
// tests/test_torch_pivot_fwd_emulated.py:
//
//   g++ -std=c++20 -O1 -pthread -ffp-contract=off -shared -fPIC
//       -o libfss_pivot_fwd_emu.so pivot_fwd_emulated.cpp

#include "cuda_emulation.h"
#include "pivot_fwd.cuh"

namespace {

template <int CO>
void run(const float* x, const float* w, const float* bias, float* y, int batch, int ci,
         int hq, int wq, int hs, int ws, int relu, int blocks) {
  const int rows = fwd_rows(ci, CO, hs, ws);
  const FwdLayout L = fwd_layout(ci, CO, ws, rows);
  const int bulk = ws % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  fss_emu::launch(blocks, L.threads, L.floats, [&] {
    pivot_fwd_kernel<CO>(x, w, bias, y, ci, hq, wq, hs, ws, batch, rows, relu, bulk);
  });
}

}  // namespace

extern "C" {

// The kernel's launch plan for a shape: out[3] = {P, support rows a tile,
// threads a CTA}; returns the shared bytes a CTA needs.
long long fss_pivot_fwd_emulated_plan(int ci, int co, int hs, int ws, int* out) {
  const FwdLayout L = fwd_layout(ci, co, ws, fwd_rows(ci, co, hs, ws));
  out[0] = L.p;
  out[1] = L.rows;
  out[2] = L.threads;
  return 4LL * L.floats;
}

// pivot_fwd_kernel on `blocks` emulated CTAs; returns 0, or -1 for a Co it
// is not instantiated for.
int fss_pivot_fwd_emulated(const float* x, const float* w, const float* bias, float* y,
                           int batch, int ci, int co, int hq, int wq, int hs, int ws, int relu,
                           int blocks) {
  switch (co) {
#define FSS_RUN(CO) \
  case CO:          \
    run<CO>(x, w, bias, y, batch, ci, hq, wq, hs, ws, relu, blocks); \
    return 0;
    FSS_RUN(1) FSS_RUN(2) FSS_RUN(3) FSS_RUN(4) FSS_RUN(5)
    FSS_RUN(6) FSS_RUN(7) FSS_RUN(8) FSS_RUN(9) FSS_RUN(10)
#undef FSS_RUN
    default:
      return -1;
  }
}

// The forward one output at a time, in the kernel's chain: acc = bias, then
// for each ci the in-plane query taps 0-8 and the in-plane support taps 0-8,
// with fmaf; then the ReLU.
void fss_pivot_fwd_chain(const float* x, const float* w, const float* bias, float* y,
                         int batch, int ci, int co, int hq, int wq, int hs, int ws, int relu) {
  const long long S = (long long)hs * ws, Q = (long long)hq * wq;
  for (int b = 0; b < batch; ++b)
    for (long long q = 0; q < Q; ++q)
      for (long long s = 0; s < S; ++s) {
        const int qi = (int)(q / wq), qj = (int)(q % wq), u = (int)(s / ws), v = (int)(s % ws);
        for (int o = 0; o < co; ++o) {
          float acc = bias[o];
          for (int c = 0; c < ci; ++c) {
            const float* xc = x + ((long long)b * ci + c) * Q * S;
            const float* wc = w + (long long)c * 18 * co;
            for (int t = 0; t < 9; ++t) {
              const int ii = qi + t / 3 - 1, jj = qj + t % 3 - 1;
              if (ii < 0 || ii >= hq || jj < 0 || jj >= wq) continue;
              acc = fmaf(wc[t * co + o], xc[((long long)ii * wq + jj) * S + s], acc);
            }
            for (int t = 0; t < 9; ++t) {
              const int uu = u + t / 3 - 1, vv = v + t % 3 - 1;
              if (uu < 0 || uu >= hs || vv < 0 || vv >= ws) continue;
              acc = fmaf(wc[(9 + t) * co + o], xc[q * S + (long long)uu * ws + vv], acc);
            }
          }
          y[(((long long)b * co + o) * Q + q) * S + s] = relu ? fmaxf(acc, 0.f) : acc;
        }
      }
}

}  // extern "C"
