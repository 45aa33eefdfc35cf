// hough4d: the direct 4D convolution of the CHM head's Hough matching, fp32
// on Hopper's CUDA cores.
//
// Replaces no TPU kernel: the JAX package computes CHM6d and CHM4d as XLA
// convolutions (few_shot_seg_cwt_tpu/models/conv4d.py, outside any Pallas
// kernel). It was added because cuDNN runs them far from their bound: CHM4d
// (1 -> 1 channel on a 60^4 volume) as a grouped direct conv2d at ~7 ms a
// call, CHM6d (9 -> 9 on 30^4) as five implicit-GEMM conv2d over folded taps
// with 9 output channels at ~12 ms, plus the route's padding and tap copies.
//
// What it computes, per batch element, on x (B, h, w, hs, ws, Ci) and a
// 5^4 kernel K (5, 5, 5, 5, Ci, Co), zero padding 2 on every axis:
//
//   y[i, j, k, l, co] = sum_{a, b, c, d, ci} K[a, b, c, d, ci, co]
//                         x[i + a - 2, j + b - 2, k + c - 2, l + d - 2, ci]
//                       (+ bias)
//
// What bounds it at 473 px (H100 SXM: 67 TFLOP/s fp32 on the CUDA cores,
// 3.35 TB/s): the taps inside the volume, 2 FLOP each. CHM4d 14.9 GFLOP,
// 0.223 ms; CHM6d 42.1 GFLOP over its 49 non-zero scale links, 0.629 ms;
// bytes (104 MB and 58 MB) take 0.031 / 0.017 ms. So both are bound by
// operations, and every operand of an FMA has to come from a register.
//
// The design:
//  - Work: a CTA owns one query position (b, i, j) and a band of support
//    rows (the whole plane where it fits 256 threads), and walks the query
//    taps (a, b) whose plane x[i + a - 2, j + b - 2] lies inside the volume:
//    a tap outside adds nothing and is skipped. CTAs are numbered with j
//    fastest, so the ones that run together read neighbouring planes,
//    which stay in L2.
//  - Staging: each tap's input plane (all Ci channels, the band's rows and
//    a two-row halo) goes to shared memory at a fixed place inside a zeroed
//    frame, so the support taps that fall off the plane read zeros and the
//    inner loop has no edge test. The plane and the tap's weights are
//    double-buffered: cp.async brings tap t+1 while tap t computes, 16
//    bytes a copy where rows start 16-byte aligned (CHM4d: its frame row
//    starts at column C0 = 4), else 8 or 4. The kernel reads x in the layout
//    it arrives in (any batch, query and channel strides; the support plane
//    contiguous), so CHM6d's channel-major view needs no copy.
//  - Registers: a thread owns a TH x TW tile of support positions and all
//    Co outputs: 8 x 4 at (1, 1), 2 x 4 at (9, 9). At (1, 1) the link's 25
//    weights sit in registers for the tap and the window's 12 rows stream
//    through, each loaded once; at (9, 9) each channel's 6 x 8 window is
//    loaded once, then each live link's 25 weights (broadcast loads) feed
//    25 TH TW FMAs from registers. Shared loads are 16-byte, of the aligned
//    run of floats that holds a window row.
//  - Links: the wrapper stores a flag beside each (ci, co) link's weights
//    of a query tap, set where any of its 25 weights is not zero, computed
//    on the card; a link whose flag is 0 is skipped (CHM6d: 32 of its 81
//    scale links are structurally zero). No host read of the weights.
//  - Sums: each output's chain is fixed: query taps in (a, b) order, then
//    ci, then (c, d), with fmaf from 0, and the bias added at the end, so
//    every launch gives the same bits (no atomics). y is written once,
//    channel-major (B, Co, h, w, hs, ws).
// Where the time goes (H100, 473 px; CTAs an SM: 2 at (9, 9) by shared
// memory, 4 at (1, 1) by registers):
// the FMA regions of the loops are 95-97% FFMA in SASS, and the copies alone
// take ~0.45 ms a call, under the FMAs; back to back a call takes ~0.55 ms
// (CHM4d) and ~1.46 ms (CHM6d), 41% and 43% of the bound. Deeper staging
// (3 or 4 taps ahead), other tiles (4 x 4, 8 x 8; 1 x 4, 1 x 8), bands of
// the plane and loading the next link's weights ahead (243 registers) were
// slower or no faster.
//
// This header is included by hough4d.cu and by hough4d_emulated.cpp, which
// runs the same kernel on the CPU through cuda_emulation.h. Device
// intrinsics come from the includer: cp_async4, cp_async8, cp_async16,
// cp_async_commit, cp_async_wait<N>, __syncthreads, FSS_SHARED.

constexpr int H4_K = 5;              // the kernel's side on every axis
constexpr int H4_R = 2;              // its zero padding
constexpr int H4_LINK = 28;          // floats of a staged link: 25 weights, the flag, 2 zeros
constexpr int H4_THREADS = 256;      // most threads a CTA runs
constexpr int H4_MAX_SMEM = 232448;  // shared memory one Hopper block may use
constexpr int H4_STAGES = 2;         // query taps in shared memory: one computes, one lands

// The support tile a thread owns, (TH, TW), for an instance (Ci, Co), the
// CTAs an SM should hold (the register cap: __launch_bounds__), and the
// frame column where a staged row starts (4: the row 16-byte aligned, for
// 16-byte copies; 2: a thread's window 16-byte aligned, 8-byte copies).
template <int CI, int CO>
struct H4Tile {
  static constexpr int TH = CI == 1 && CO == 1 ? 8 : 2;
  static constexpr int TW = 4;
  static constexpr int MIN_CTAS = CI == 1 && CO == 1 ? 2 : 1;
  static constexpr int C0 = CI == 1 && CO == 1 ? 4 : 2;
};

// One launch's shape, and the CTA's shared-memory layout in floats (the
// same on the host and the device; offsets are multiples of 4).
struct H4Layout {
  int tiles_c;    // thread tiles across a support row
  int band;       // support rows a CTA owns (a multiple of th)
  int bands;      // CTAs a query position: ceil(hs / band)
  int threads;    // (band / th) * tiles_c
  int rows, ld;   // a staged plane: band + 4 rows of ld floats (tiles_c tw + 2 c0)
  int xplane;     // one staged plane, every channel: ci * rows * ld
  int wplane;     // one query tap's links: ci * co * H4_LINK
  int floats;     // H4_STAGES weight buffers, then as many plane buffers
};

// The layout with the band of the most support rows that H4_THREADS threads
// cover (all hs where they do).
__host__ __device__ inline H4Layout h4_layout(int ci, int co, int th, int tw, int c0, int hs,
                                              int ws) {
  H4Layout L;
  L.tiles_c = (ws + tw - 1) / tw;
  int tr = H4_THREADS / L.tiles_c;
  const int tr_all = (hs + th - 1) / th;
  if (tr > tr_all) tr = tr_all;
  if (tr < 1) tr = 1;
  L.band = tr * th;
  L.bands = (hs + L.band - 1) / L.band;
  L.threads = tr * L.tiles_c;
  L.rows = L.band + 2 * H4_R;
  L.ld = L.tiles_c * tw + 2 * c0;
  L.xplane = ci * L.rows * L.ld;
  L.wplane = ci * co * H4_LINK;
  L.floats = H4_STAGES * (L.wplane + L.xplane);
  return L;
}

// N floats from shared memory, 16 bytes a load.
template <int N>
__device__ __forceinline__ void h4_load(const float* src, float* dst) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    dst[i] = v.x;
    dst[i + 1] = v.y;
    dst[i + 2] = v.z;
    dst[i + 3] = v.w;
  }
}

// Stage query tap (qa, qb) of position (b, i, j) into buffer `buf`: the
// plane's rows [r_lo, r_hi) of every channel, V floats a copy, each row at
// frame row (r - k0 + 2), column C0; and the tap's links. (r0, l0) is this
// thread's first (row, chunk) of a channel, (dr, dl) its step: the same
// for every channel and tap, so no division is left in the loop.
template <int CI, int CO, int V, int C0>
__device__ __forceinline__ void h4_stage(const H4Layout& L, float* smem, int buf,
                                         const float* __restrict__ x,
                                         const float* __restrict__ wt, long long plane,
                                         long long sc, int tap, int r_lo, int r_hi, int k0,
                                         int ws, int r0, int l0, int dr, int dl) {
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  float* wdst = smem + buf * L.wplane;
  const float* wsrc = wt + (long long)tap * L.wplane;
  for (int e = tid; e < L.wplane / 4; e += nt) cp_async16(wdst + 4 * e, wsrc + 4 * e);
  float* xdst =
      smem + H4_STAGES * L.wplane + buf * L.xplane + (r_lo - k0 + H4_R) * L.ld + C0;
  const float* xsrc = x + plane + (long long)r_lo * ws;
  const int n_rows = r_hi - r_lo, wv = ws / V;
#pragma unroll 1
  for (int c = 0; c < CI; ++c) {
    const float* src = xsrc + c * sc;
    float* dst = xdst + c * L.rows * L.ld;
    for (int r = r0, l = l0; r < n_rows;) {
      if constexpr (V == 4)
        cp_async16(dst + r * L.ld + 4 * l, src + (long long)r * ws + 4 * l);
      else if constexpr (V == 2)
        cp_async8(dst + r * L.ld + 2 * l, src + (long long)r * ws + 2 * l);
      else
        cp_async4(dst + r * L.ld + l, src + (long long)r * ws + l);
      l += dl;
      r += dr;
      if (l >= wv) {
        l -= wv;
        ++r;
      }
    }
  }
}

// y (B, CO, h, w, hs, ws) channel-major; x strides sb, sh, sw, sc in floats
// (the support plane contiguous); wt (25, CI, CO, H4_LINK) the links of each
// query tap a * 5 + b; bias (CO values at stride bias_stride, or null). The
// grid is B * bands * h * w CTAs of L.threads threads; V floats a copy: 4
// where C0 = 4 and every staged row starts 16-byte aligned, 2 where 8-byte
// aligned, else 1.
template <int CI, int CO, int V>
__global__ void __launch_bounds__(H4_THREADS, H4Tile<CI, CO>::MIN_CTAS)
hough4d_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ bias, float* __restrict__ y, int h, int w, int hs,
               int ws, long long sb, long long sh, long long sw, long long sc,
               int bias_stride) {
  using T = H4Tile<CI, CO>;
  constexpr int TH = T::TH, TW = T::TW, S = H4_STAGES, C0 = T::C0;
  // a window row is read as the 16-byte-aligned run of NW floats that holds
  // it: its first column sits OFF floats in
  constexpr int OFF = C0 - H4_R, NW = (TW + 2 * H4_R + OFF + 3) / 4 * 4;
  FSS_SHARED(smem);
  const H4Layout L = h4_layout(CI, CO, TH, TW, C0, hs, ws);
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;

  // this CTA's query position and band
  long long blk = blockIdx.x;
  const int j = (int)(blk % w);
  blk /= w;
  const int i = (int)(blk % h);
  blk /= h;
  const int band = (int)(blk % L.bands);
  const int b = (int)(blk / L.bands);
  const int k0 = band * L.band;
  const int r_lo = k0 - H4_R > 0 ? k0 - H4_R : 0;
  const int r_hi = k0 + L.band + H4_R < hs ? k0 + L.band + H4_R : hs;
  // the query taps inside the volume: a in [a0, a1), b in [b0, b1)
  const int a0 = i < H4_R ? H4_R - i : 0, a1 = h - i + H4_R < H4_K ? h - i + H4_R : H4_K;
  const int b0 = j < H4_R ? H4_R - j : 0, b1 = w - j + H4_R < H4_K ? w - j + H4_R : H4_K;
  const int nb = b1 - b0, n_taps = (a1 - a0) * nb;

  // this thread's first (row, chunk) of a channel's staging, and its step
  const int wv = ws / V;
  const int r0 = tid / wv, l0 = tid - r0 * wv, dr = nt / wv, dl = nt - dr * wv;
  auto plane_of = [&](int t, int* tap) {
    const int qa = a0 + t / nb, qb = b0 + t % nb;
    *tap = qa * H4_K + qb;
    return b * sb + (long long)(i + qa - H4_R) * sh + (long long)(j + qb - H4_R) * sw;
  };
  auto stage = [&](int t, int buf) {
    int tap;
    const long long plane = plane_of(t, &tap);
    h4_stage<CI, CO, V, C0>(L, smem, buf, x, wt, plane, sc, tap, r_lo, r_hi, k0, ws, r0, l0,
                            dr, dl);
  };

  // the frames: zero once, so rows and columns off the plane stay zero
  for (int e = tid; e < L.floats; e += nt) smem[e] = 0.f;
  __syncthreads();

  const int tr = tid / L.tiles_c, tc = tid - tr * L.tiles_c;
  float acc[CO][TH][TW];
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int p = 0; p < TH; ++p)
#pragma unroll
      for (int q = 0; q < TW; ++q) acc[o][p][q] = 0.f;

  // one commit group a tap (empty past the last), S - 1 taps ahead
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_taps) stage(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < n_taps; ++t) {
    const int buf = t % S;
    if (t + S - 1 < n_taps) stage(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    cp_async_wait<S - 1>();  // every group but the newest S - 1: tap t's
    __syncthreads();         // tap t's plane and links, every thread's copies

    const float* wl = smem + buf * L.wplane;
    const float* xw = smem + S * L.wplane + buf * L.xplane + tr * TH * L.ld + tc * TW;
#pragma unroll 1
    for (int c = 0; c < CI; ++c) {
      const float* xc = xw + c * L.rows * L.ld;
      if constexpr (CO == 1) {
        // one link a channel: its 25 weights stay in registers while the
        // window's rows stream through, each row loaded once
        const float* lk = wl + c * H4_LINK;
        const float4 tail = *reinterpret_cast<const float4*>(lk + 24);
        if (tail.y == 0.f) continue;  // a link with no weight: uniform over the CTA
        float wk[H4_K * H4_K];
        h4_load<24>(lk, wk);
        wk[24] = tail.x;
#pragma unroll
        for (int r = 0; r < TH + 2 * H4_R; ++r) {
          float row[NW];
          h4_load<NW>(xc + r * L.ld, row);
#pragma unroll
          for (int dc = 0; dc < H4_K; ++dc) {
            const int p = r - dc;  // the output row this window row feeds at tap row dc
            if (p < 0 || p >= TH) continue;
#pragma unroll
            for (int dd = 0; dd < H4_K; ++dd)
#pragma unroll
              for (int q = 0; q < TW; ++q)
                acc[0][p][q] = fmaf(wk[dc * H4_K + dd], row[OFF + q + dd], acc[0][p][q]);
          }
        }
      } else {
        // the channel's window in registers, then each live link's weights
        float win[TH + 2 * H4_R][NW];
#pragma unroll
        for (int r = 0; r < TH + 2 * H4_R; ++r) h4_load<NW>(xc + r * L.ld, win[r]);
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          const float* lk = wl + (c * CO + o) * H4_LINK;
          const float4 tail = *reinterpret_cast<const float4*>(lk + 24);
          if (tail.y == 0.f) continue;  // a link with no weight: uniform over the CTA
          float wk[H4_K * H4_K];
          h4_load<24>(lk, wk);
          wk[24] = tail.x;
#pragma unroll
          for (int dc = 0; dc < H4_K; ++dc)
#pragma unroll
            for (int dd = 0; dd < H4_K; ++dd)
#pragma unroll
              for (int p = 0; p < TH; ++p)
#pragma unroll
                for (int q = 0; q < TW; ++q)
                  acc[o][p][q] =
                      fmaf(wk[dc * H4_K + dd], win[p + dc][OFF + q + dd], acc[o][p][q]);
        }
      }
    }
    __syncthreads();  // the next iteration stages tap t + S into this buffer
  }

  // y once, with the bias
  const long long pos = (long long)i * w + j, vol = (long long)hs * ws;
  const int k_end = k0 + L.band < hs ? k0 + L.band : hs;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const float bv = bias ? bias[o * bias_stride] : 0.f;
    float* yo = y + (((long long)b * CO + o) * h * w + pos) * vol;
#pragma unroll
    for (int p = 0; p < TH; ++p) {
      const int k = k0 + tr * TH + p;
      if (k >= k_end) continue;
#pragma unroll
      for (int q = 0; q < TW; ++q) {
        const int l = tc * TW + q;
        if (l < ws) yo[(long long)k * ws + l] = bias ? acc[o][p][q] + bv : acc[o][p][q];
      }
    }
  }
}
