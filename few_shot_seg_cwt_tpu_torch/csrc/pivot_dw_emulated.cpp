// pivot_dw_mma_kernel (pivot_dw.cuh) run on the CPU through
// cuda_emulation.h, then its CTAs' partial rows summed in order in double
// as pivot_dw_reduce_kernel sums them, as a shared library for
// tests/test_torch_pivot_dw_emulated.py:
//
//   g++ -std=c++20 -O1 -pthread -ffp-contract=off -shared -fPIC
//       -o libfss_pivot_dw_emu.so pivot_dw_emulated.cpp

#include "cuda_emulation.h"
#include "pivot_dw.cuh"

namespace {

template <int CO>
void run(const float* x, const float* g, float* out, int batch, int ci, int hq, int wq, int hs,
         int ws, int blocks, int bulk) {
  const DwLayout L = dw_plan(ci, CO, ws);
  std::vector<float> partial((size_t)blocks * L.n_out, std::numeric_limits<float>::quiet_NaN());
  fss_emu::launch(blocks, DW_THREADS, L.floats, [&] {
    pivot_dw_mma_kernel<CO>(x, g, partial.data(), ci, hq, wq, hs, ws, batch, L.rows, L.nc,
                            bulk);
  });
  for (int j = 0; j < L.n_out; ++j) {
    double sum = 0.0;
    for (int b = 0; b < blocks; ++b) sum += partial[(size_t)b * L.n_out + j];
    out[j] = (float)sum;
  }
}

}  // namespace

extern "C" {

// The kernel's layout for a shape: out[4] = {support rows a step, column
// slots, g slots, threads a CTA}; returns the shared bytes a CTA needs.
long long fss_pivot_dw_emulated_plan(int ci, int co, int ws, int* out) {
  const DwLayout L = dw_plan(ci, co, ws);
  out[0] = L.rows;
  out[1] = L.nc;
  out[2] = L.ng;
  out[3] = DW_THREADS;
  return 4LL * L.floats;
}

// out (18*ci*co + co), as fss_pivot_dw gives it, from `blocks` emulated
// CTAs; `bulk` 1 stages by bulk copies (ws % 4 == 0 and 16-byte aligned
// pointers), 0 by the producer's lanes. Returns 0, or -1 for a Co it is
// not instantiated for or a bulk staging the shape cannot take.
int fss_pivot_dw_emulated(const float* x, const float* g, float* out, int batch, int ci, int co,
                          int hq, int wq, int hs, int ws, int blocks, int bulk) {
  if (bulk && (ws % 4 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)g % 16 != 0)) return -1;
  switch (co) {
#define FSS_RUN(CO) \
  case CO:          \
    run<CO>(x, g, out, batch, ci, hq, wq, hs, ws, blocks, bulk); \
    return 0;
    FSS_RUN(1) FSS_RUN(2) FSS_RUN(3) FSS_RUN(4) FSS_RUN(5)
    FSS_RUN(6) FSS_RUN(7) FSS_RUN(8) FSS_RUN(9) FSS_RUN(10)
#undef FSS_RUN
    default:
      return -1;
  }
}

}  // extern "C"
