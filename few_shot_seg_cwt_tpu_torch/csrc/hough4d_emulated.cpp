// hough4d_kernel (hough4d.cuh) run on the CPU through cuda_emulation.h, and
// the per-output chain it must reproduce, as a shared library for
// tests/test_torch_hough4d.py:
//
//   g++ -std=c++20 -O1 -pthread -ffp-contract=off -shared -fPIC
//       -o libfss_hough4d_emu.so hough4d_emulated.cpp

#include "cuda_emulation.h"
#include "hough4d.cuh"

namespace {

template <int CI, int CO, int V>
void run(const float* x, const float* wt, const float* bias, float* y, int batch, int h, int w,
         int hs, int ws, long long sb, long long sh, long long sw, long long sc, int bias_stride) {
  const H4Layout L =
      h4_layout(CI, CO, H4Tile<CI, CO>::TH, H4Tile<CI, CO>::TW, H4Tile<CI, CO>::C0, hs, ws);
  fss_emu::launch(batch * L.bands * h * w, L.threads, L.floats, [&] {
    hough4d_kernel<CI, CO, V>(x, wt, bias, y, h, w, hs, ws, sb, sh, sw, sc, bias_stride);
  });
}

template <int CI, int CO>
void run_pick(const float* x, const float* wt, const float* bias, float* y, int batch, int h,
              int w, int hs, int ws, long long sb, long long sh, long long sw, long long sc,
              int bias_stride) {
  // the card's choice: the widest copies for which every staged row starts aligned
  auto aligned = [&](int v) {
    return ws % v == 0 && (uintptr_t)x % (4 * v) == 0 && sb % v == 0 && sh % v == 0 &&
           sw % v == 0 && (CI == 1 || sc % v == 0);
  };
  if (H4Tile<CI, CO>::C0 == 4 && aligned(4))
    run<CI, CO, 4>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride);
  else if (aligned(2))
    run<CI, CO, 2>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride);
  else
    run<CI, CO, 1>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride);
}

}  // namespace

extern "C" {

// The launch plan, as fss_hough4d_plan on the card: out[4] = {threads,
// support rows a CTA, CTAs a query position, shared bytes}; -1 for a (ci,
// co) with no instance.
int fss_hough4d_emulated_plan(int ci, int co, int hs, int ws, long long* out) {
  H4Layout L;
  if (ci == 1 && co == 1)
    L = h4_layout(1, 1, H4Tile<1, 1>::TH, H4Tile<1, 1>::TW, H4Tile<1, 1>::C0, hs, ws);
  else if (ci == 9 && co == 9)
    L = h4_layout(9, 9, H4Tile<9, 9>::TH, H4Tile<9, 9>::TW, H4Tile<9, 9>::C0, hs, ws);
  else
    return -1;
  out[0] = L.threads;
  out[1] = L.band;
  out[2] = L.bands;
  out[3] = 4LL * L.floats;
  return 0;
}

// hough4d_kernel on every CTA of the launch, one CTA after another; returns
// 0, or -1 for a (ci, co) with no instance.
int fss_hough4d_emulated(const float* x, const float* wt, const float* bias, float* y,
                         int batch, int h, int w, int hs, int ws, int ci, int co, long long sb,
                         long long sh, long long sw, long long sc, int bias_stride) {
  if (ci == 1 && co == 1)
    run_pick<1, 1>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride);
  else if (ci == 9 && co == 9)
    run_pick<9, 9>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride);
  else
    return -1;
  return 0;
}

// The convolution one output at a time, in the kernel's chain: acc = 0, then
// for each query tap (a, b) inside the volume, each ci whose link flag is
// set, each support tap (c, d) in order, fmaf with x or the padding's 0;
// then the bias. y is channel-major (B, co, h, w, hs, ws).
void fss_hough4d_chain(const float* x, const float* wt, const float* bias, float* y, int batch,
                       int h, int w, int hs, int ws, int ci, int co, long long sb, long long sh,
                       long long sw, long long sc, int bias_stride) {
  const long long vol = (long long)hs * ws;
  for (int b = 0; b < batch; ++b)
    for (int o = 0; o < co; ++o)
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          for (int k = 0; k < hs; ++k)
            for (int l = 0; l < ws; ++l) {
              float acc = 0.f;
              for (int a = 0; a < H4_K; ++a)
                for (int bb = 0; bb < H4_K; ++bb) {
                  const int ii = i + a - H4_R, jj = j + bb - H4_R;
                  if (ii < 0 || ii >= h || jj < 0 || jj >= w) continue;
                  for (int c = 0; c < ci; ++c) {
                    const float* lk = wt + ((long long)((a * H4_K + bb) * ci + c) * co + o) *
                                               H4_LINK;
                    if (lk[25] == 0.f) continue;
                    const float* xp = x + b * sb + ii * sh + jj * sw + c * sc;
                    for (int dc = 0; dc < H4_K; ++dc)
                      for (int dd = 0; dd < H4_K; ++dd) {
                        const int kk = k + dc - H4_R, ll = l + dd - H4_R;
                        const bool in = kk >= 0 && kk < hs && ll >= 0 && ll < ws;
                        acc = fmaf(lk[dc * H4_K + dd], in ? xp[(long long)kk * ws + ll] : 0.f,
                                   acc);
                      }
                  }
                }
              y[(((long long)b * co + o) * h * w + (long long)i * w + j) * vol +
                (long long)k * ws + l] = bias ? acc + bias[o * bias_stride] : acc;
            }
}

}  // extern "C"
