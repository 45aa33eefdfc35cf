// Closed-form K=2 episodic inner loop on Hopper (sm_90a), all steps in one launch,
// each episode spread over many SMs.
//
// Two kernels share one body, `adapt_binary_body<TILE>`:
// * K1 `adapt_binary_kernel` replaces the TPU kernel `_kernel` /
//   `adapt_binary_pallas` in few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py
//   (dispatched from episodic/inner_loop.py:_adapt_binary); any shot >= 1.
// * K2 `adapt_binary_tiled_kernel<TILE>` replaces `_tiled_kernel` /
//   `adapt_binary_pallas_tiled` in the same file (dispatched under the
//   engines' episode vmap when FSS_INNER_TILE > 1): 1-shot episodes, TILE
//   (2, 3 or 4) of them carried by every CTA, so that one tap lookup and
//   one barrier serve TILE independent chains, as the TPU kernel interleaves
//   them.
//
// What it computes, per episode e (shots s, pixels p of the h x w feature
// map, channels c), for num_steps steps starting from acc = 0:
//
//   u      = u0 - 2*lr*acc                                   (C)
//   d_s    = f_s . u                                         (h, w)
//   D_s    = A d_s B^T                                       (H, W)
//   g_s    = |pws_s| * (sigmoid(D_s) - 1/2) + pws_s / 2     (H, W)
//   G_s    = A^T g_s B                                       (h, w)
//   acc   += sum_s sum_p G_s[p] * f_s[p, :]                  (C)
//
// A (H, h) and B (W, w) are the align-corners interpolation matrices and
// pws = pw - 2*pw*y is the sign-packed, normalised pixel weight. The caller
// forms the adapted rows W0 + lr*acc and W1 - lr*acc. fp32 throughout. g is
// evaluated as pws * sigmoid(sign(pws) * D), the same value: where sigmoid
// saturates (most pixels at a raw init's feature norms) the form above
// subtracts two near-equal terms and keeps only a few bits of g.
//
// Design.
// * A persistent cooperative grid (cudaLaunchCooperativeKernel), sized by
//   the wrapper from the card's SM count and the occupancy query
//   (ops/inner_loop_plan.py:work_plan): P CTAs per group of TILE episodes,
//   P = min(h, resident CTAs / groups); groups beyond what is resident run
//   in waves on the same CTAs. CTA j of a group owns the whole feature rows
//   [j*h/P, (j+1)*h/P) (a slice) of every chain (episode shot) of the
//   group, and the output rows whose lower tap lies in the slice. At 473 px
//   and E = 8 that is 16 CTAs per episode (128 SMs); at E <= 2, 60 per
//   episode (one feature row each: whole rows cap P at h = 60, so E = 1
//   uses 60 of the card's SMs).
// * Per step each CTA computes d for its pixels (it holds all C channels,
//   so no reduction); T = d B^T and then D and g for its output rows, with
//   one halo row of d from the next slice; A^T g for its feature rows as
//   two row sums each (over the output rows whose lower tap is the row, and
//   over those whose upper tap is), the upper sum of the next slice's first
//   row going to that slice as a halo row of W floats; G = (A^T g) B for
//   its pixels; and one partial acc per feature row (sum over the row's
//   pixels and the shots). Every CTA of the group then reduces the h row
//   partials in one fixed order (four interleaved sequential sums added
//   pairwise), so all hold the same acc. Three barriers a step: after d,
//   after A^T g and after the partials. No float atomics anywhere.
// * G is (A^T g) B, the association of the TPU kernel and of the plain
//   version; its halo is one W-wide row, where A^T (g B) would hand over up
//   to nine w-wide gB rows.
// * The barriers are per group, hand-written: an arrival counter in global
//   memory (one per resident group, zeroed by the wrapper) that only grows,
//   so barrier n waits for n*P arrivals; thread 0 arrives after a
//   __threadfence and spins with ld.acquire.gpu; data crossing CTAs is read
//   with ld.global.cg (L2, never a stale L1 line). The cooperative launch
//   is there for its guarantee that the whole grid is resident (a spin
//   barrier would hang otherwise) and to refuse a grid the card cannot
//   hold; cooperative_groups' grid.sync() would join all groups where one
//   group's CTAs suffice. Thread-block clusters with DSMEM were the other
//   choice: a cluster of at most 16 CTAs leaves most of the card idle at
//   E <= 4.
// * A and B are read only through their two-tap tables, built on the host
//   from resize.interp_matrix_align_corners (its fp32 values): per output
//   index the lower input index and two weights, per input index the
//   contiguous output range with a non-zero weight on it. T costs two FMAs
//   an element, D two, A^T g two, and G is a short contiguous gather. The
//   tables live in shared memory. Nothing H x W-sized is stored anywhere:
//   a thread per output column computes D and g down the column and adds
//   them into A^T g as it goes.
// * f: each CTA pins the first pixels of its slice (per chain) in the
//   shared memory left over by the layout, and streams the rest straight
//   into registers with 16-byte read-only loads (d = f.u: a warp per
//   pixel, two pixels and eight 16-byte loads per lane in flight; acc:
//   four threads per float4 of channels split the row's pixels). Both
//   passes read the same pinned copy. At E <= 2 every CTA pins its whole
//   slice; at E = 8 91 of its 240 pixels (38%). A ring of cp.async copies
//   in shared memory (4 slots of 8 pixels, three ahead of the reads, a
//   block barrier a slot) was measured in place of the register loads and
//   lost (PERF.md, PR 4): its 64 KB cost 32 pinned pixels a CTA, so at
//   E = 8 the streamed set grew from 39 to 47 MB a pass, past what L2
//   keeps, and K1 went from 10.3 to 13.4 ms; at E = 4, all of it in L2, a
//   streamed pixel still cost more through the ring (4.95 -> 6.04 ms).
// * The sums that feed acc, each row's partial over its pixels and shots and
//   the reduction over the rows, are compensated (Dot2 / TwoSum in fp32: a
//   second float gathers the rounding errors). acc += sum_p G[p] f[p, :]
//   cancels heavily (g balances pw * (sigmoid - y)) and its error enters
//   the state that the remaining steps grow. With plain fp32 sums this
//   kernel failed chip_smoke.py's raw-init witness, where the 200-step loop
//   is chaotic: it left the fp64 run over 4x as far as the plain torch
//   loops did (PERF.md, Findings).
// * Determinism and independence from the partition: every element of d,
//   T, D, g, A^T g and G has one formula with explicit fmaf/_rn operations,
//   each row partial sums its pixels in a fixed order, and the rows'
//   reduction order does not depend on P. So an episode's acc does not
//   depend on E, on the tile or on the card's SM count: K2 equals K1 bit
//   for bit, and two launches give the same bits.
//
// Bound: per 1-shot step at 473 px with 60x60x512 features, 2*3600*512*2
// FLOP for d = f.u and acc += G.f, plus the interpolation products counted
// by the non-zeros of A and B and ~5 ops per pixel for g: ~10.4 MFLOP,
// 16.6 GFLOP for 8 episodes x 200 steps, 0.248 ms at 67 TFLOP/s
// (operations; chip_smoke.py:inner_loop_work). The floor of this design is
// the bytes of f it streams: at E = 8, (240 - 91) pixels x 2 KB x 128 CTAs
// twice a step, 78 MB, 23 us from HBM or about a third of that where the
// 39 MB stay in the 50 MB L2: 1.5 to 4.6 ms over 200 steps; plus 600
// group barriers of ~1-2 us each. What limits it on the card (the phase
// clocks below; tools/profile_inner_loop.py, numbers in PERF.md), at
// ~10 ms for E = 8: neither fp32 issue nor bandwidth. The acc partials take
// over a quarter (f at ~17 B a cycle per SM, far below what L2 delivers,
// and the compensated sums' extra adds), D, g and A^T g a fifth (an expf
// and an IEEE reciprocal per element, under three FMAs a cycle), and the
// three barrier waits a fifth, most of it waiting for the slowest slice
// (slices of 3 and 4 rows).
//
// Built with -DFSS_PHASE_CLOCKS, thread 0 of each CTA reads clock64() at
// the end of every phase (after the block-wide barrier that closes it) and
// adds the cycles to a device counter per phase, read by
// fss_phase_cycles(); the waits at the three group barriers are phases of
// their own. The default build has none of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;                 // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC4 = kThreads / 4;          // float4 channel groups: C <= 512
constexpr int kLaneC4 = kMaxC4 / 32;          // float4 of u per lane in d = f.u

struct Params {
  int E, shot, h, w, C, H, W, num_steps;
  float lr;
  int P;       // CTAs per group of TILE episodes (row slices)
  int n_conc;  // groups resident at once (grid = n_conc * P)
  int rows;    // most feature rows in a slice
  int pin;     // pixels of f per chain held in shared memory
};

#ifdef FSS_PHASE_CLOCKS
// d = f.u, barrier 1, T = d B^T, D + g + A^T g, A^T g halo out, barrier 2,
// G = (A^T g) B,
// acc partials, barrier 3, acc reduce + u
constexpr int kPhases = 10;
__device__ unsigned long long fss_phase_cycles_dev[kPhases];
#define PHASE_MARK(i)                              \
  do {                                             \
    if (tid == 0) {                                \
      const long long now = clock64();             \
      ph[i] += (unsigned long long)(now - t_last); \
      t_last = now;                                \
    }                                              \
  } while (0)
#else
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#endif

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// Words of one axis's tap table (out outputs from in inputs): lo, w0, w1
// (out each), first (in + 1), begin, end (in each).
__host__ __device__ inline int axis_words(int out, int in) { return 3 * out + 3 * in + 1; }

struct Axis {
  int lo, w0, w1, first, begin, end;  // word offsets in the table
};

__host__ __device__ inline Axis make_axis(int off, int out, int in) {
  Axis a;
  a.lo = off;
  a.w0 = off + out;
  a.w1 = off + 2 * out;
  a.first = off + 3 * out;
  a.begin = a.first + in + 1;
  a.end = a.begin + in;
  return a;
}

// Shared-memory layout in floats; every segment starts 16-byte aligned.
// Per episode t (at ep0 + t*ep): u, acc. Per chain c (at ch0 + c*ch): d
// ((rows+1) x w: own rows, then the halo row), T ((rows+1) x W), Sl
// ((rows+1) x W: per feature row r0 + kk, the sum of A^T g over the output
// rows whose upper tap it is; row 0 is the halo), Su (rows x W: the same
// over lower taps), G (rows x w). Then pin pixels of f per chain.
// ops/inner_loop_plan.py:smem_bytes mirrors this.
struct Layout {
  size_t tab, ep0, ep, acc, ch0, ch, T, Sl, Su, G, f, total_floats;
};

__host__ __device__ inline Layout make_layout(int h, int w, int C, int H, int W, int shot,
                                              int tile, int rows, int pin) {
  Layout L;
  size_t o = 0;
  L.tab = o;  o += round4((size_t)axis_words(H, h) + axis_words(W, w));
  L.ep0 = o;
  L.acc = round4(C);
  L.ep = 2 * round4(C);
  o += (size_t)tile * L.ep;
  L.ch0 = o;
  L.T = round4((size_t)(rows + 1) * w);
  L.Sl = L.T + round4((size_t)(rows + 1) * W);
  L.Su = L.Sl + round4((size_t)(rows + 1) * W);
  L.G = L.Su + round4((size_t)rows * W);
  L.ch = L.G + round4((size_t)rows * w);
  o += (size_t)tile * shot * L.ch;
  L.f = o;    o += (size_t)tile * shot * pin * C;
  L.total_floats = o;
  return L;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float v) {
  v = fmaf(a.x, b.x, v);
  v = fmaf(a.y, b.y, v);
  v = fmaf(a.z, b.z, v);
  return fmaf(a.w, b.w, v);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int mask) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, mask), __shfl_xor_sync(0xffffffffu, v.y, mask),
                     __shfl_xor_sync(0xffffffffu, v.z, mask), __shfl_xor_sync(0xffffffffu, v.w, mask));
}

// s + c += t exactly as a pair (TwoSum): s holds the rounded sum, c
// gathers the rounding errors.
__device__ __forceinline__ void two_sum_acc(float& s, float& c, float t) {
  const float n = __fadd_rn(s, t);
  const float bp = __fsub_rn(n, s);
  c = __fadd_rn(c, __fadd_rn(__fsub_rn(s, __fsub_rn(n, bp)), __fsub_rn(t, bp)));
  s = n;
}

// s + c += a * b with the product's rounding error too (Dot2).
__device__ __forceinline__ void dot2_acc(float& s, float& c, float a, float b) {
  const float p = __fmul_rn(a, b);
  two_sum_acc(s, c, p);
  c = __fadd_rn(c, fmaf(a, b, -p));
}

// Pairs (s, c) of the four threads of a channel group, added pairwise.
__device__ __forceinline__ float4 quad_sum(float4 s, float4 c) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float4 os = shfl_xor4(s, o), oc = shfl_xor4(c, o);
    two_sum_acc(s.x, c.x, os.x);
    two_sum_acc(s.y, c.y, os.y);
    two_sum_acc(s.z, c.z, os.z);
    two_sum_acc(s.w, c.w, os.w);
    c = add4(c, oc);
  }
  return add4(s, c);
}

// float4 group k of pixel q of a slice: pinned in shared memory or streamed.
__device__ __forceinline__ float4 f4_at(const float4* sf, const float4* __restrict__ gf, int q,
                                        int npin, int C4, int k) {
  return q < npin ? sf[(size_t)q * C4 + k] : __ldg(gf + (size_t)q * C4 + k);
}

// Barrier among the P CTAs of one group: the counter only grows, so the
// n-th barrier of the group waits for n*P arrivals. A wait of over ~2e10
// cycles (seconds) means a CTA will never arrive: the kernel traps, and the
// launch fails, instead of hanging the card.
__device__ __forceinline__ void group_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const long long t0 = clock64();
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
      if (clock64() - t0 > 20000000000LL) __trap();
    } while ((int)(seen - target) < 0);
    __threadfence();
  }
  __syncthreads();
}

// The inner loop of the groups of TILE episodes this CTA takes part in:
// groups slot, slot + n_conc, ..., slice j of each.
template <int TILE>
__device__ __forceinline__ void adapt_binary_body(
    const float* __restrict__ fs, const float* __restrict__ pws,
    const float* __restrict__ u0, const int* __restrict__ taps, float* dh, float* gbh,
    float* part, unsigned* counters, float* __restrict__ acc_out, const Params& p) {
  extern __shared__ __align__(16) float smem[];
  const int h = p.h, w = p.w, C = p.C, H = p.H, W = p.W, shot = p.shot;
  const Layout L = make_layout(h, w, C, H, W, shot, TILE, p.rows, p.pin);
  const int* tab = reinterpret_cast<const int*>(smem + L.tab);
  const Axis ra = make_axis(0, H, h);
  const Axis ca = make_axis(axis_words(H, h), W, w);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chains = TILE * shot;
  const int hw = h * w;
  const int C4 = C >> 2;
  const float scale = 2.0f * p.lr;
  const int slot = blockIdx.x / p.P;
  const int j = blockIdx.x - slot * p.P;
  const int r0 = j * h / p.P, r1 = (j + 1) * h / p.P, nr = r1 - r0;
  const bool has_prev = r0 > 0, has_next = r1 < h;
  const int nT = nr + (has_next ? 1 : 0);
  const int npin = min(p.pin, nr * w);
  unsigned* counter = counters + slot;
  unsigned n_bar = 0;
  const int cg = tid >> 2;  // float4 channel group of the channel passes
  const int sub = tid & 3;  // its thread among four (pixels or rows mod 4)
  const bool cg_ok = cg < C4;
  float4* part4 = reinterpret_cast<float4*>(part);

  {
    int* s_tab = reinterpret_cast<int*>(smem + L.tab);
    const int n = axis_words(H, h) + axis_words(W, w);
    for (int i = tid; i < n; i += kThreads) s_tab[i] = taps[i];
  }
  __syncthreads();
  const int i0 = tab[ra.first + r0], i1 = tab[ra.first + r1];  // own output rows
#ifdef FSS_PHASE_CLOCKS
  unsigned long long ph[kPhases] = {};
  long long t_last = 0;
#endif

#define EPI(t) (smem + L.ep0 + (size_t)(t) * L.ep)
#define CHN(c) (smem + L.ch0 + (size_t)(c) * L.ch)
#define TAPW(i) __int_as_float(tab[i])

  for (int grp = slot; grp < p.E / TILE; grp += p.n_conc) {
    const int e0 = grp * TILE;
    const size_t gc0 = (size_t)e0 * shot;  // global index of chain 0
    for (int c = 0; c < chains; ++c) {
      const float4* gf =
          reinterpret_cast<const float4*>(fs + ((gc0 + c) * hw + (size_t)r0 * w) * C);
      float4* sf = reinterpret_cast<float4*>(smem + L.f + (size_t)c * p.pin * C);
      for (int i = tid; i < npin * C4; i += kThreads) sf[i] = __ldg(gf + i);
    }
#pragma unroll
    for (int t = 0; t < TILE; ++t)
      for (int k = tid; k < C; k += kThreads) {
        EPI(t)[L.acc + k] = 0.0f;
        EPI(t)[k] = u0[(size_t)(e0 + t) * C + k];
      }
    __syncthreads();
#ifdef FSS_PHASE_CLOCKS
    t_last = clock64();
#endif

    for (int step = 0; step < p.num_steps; ++step) {
      // d = f . u: a warp per pixel, two pixels at a time; u in registers.
      for (int c = 0; c < chains; ++c) {
        const float4* u4 = reinterpret_cast<const float4*>(EPI(c / shot));
        float4 ur[kLaneC4];
#pragma unroll
        for (int m = 0; m < kLaneC4; ++m) {
          const int k = lane + 32 * m;
          ur[m] = k < C4 ? u4[k] : zero4();
        }
        const size_t gc = gc0 + c;
        const float4* gf = reinterpret_cast<const float4*>(fs + (gc * hw + (size_t)r0 * w) * C);
        const float4* sf = reinterpret_cast<const float4*>(smem + L.f + (size_t)c * p.pin * C);
        float* d = CHN(c);
        for (int q = warp; q < nr * w; q += 2 * kWarps) {
          const int q2 = q + kWarps;
          const bool two = q2 < nr * w;
          float4 fa[kLaneC4], fb[kLaneC4];
#pragma unroll
          for (int m = 0; m < kLaneC4; ++m) {
            const int k = lane + 32 * m;
            fa[m] = k < C4 ? f4_at(sf, gf, q, npin, C4, k) : zero4();
            fb[m] = (two && k < C4) ? f4_at(sf, gf, q2, npin, C4, k) : zero4();
          }
          float va = 0.0f, vb = 0.0f;
#pragma unroll
          for (int m = 0; m < kLaneC4; ++m) {
            va = dot4(fa[m], ur[m], va);
            vb = dot4(fb[m], ur[m], vb);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            va = __fadd_rn(va, __shfl_xor_sync(0xffffffffu, va, o));
            vb = __fadd_rn(vb, __shfl_xor_sync(0xffffffffu, vb, o));
          }
          if (lane == 0) {
            d[q] = va;
            if (has_prev && q < w) dh[gc * hw + (size_t)r0 * w + q] = va;
            if (two) {
              d[q2] = vb;
              if (has_prev && q2 < w) dh[gc * hw + (size_t)r0 * w + q2] = vb;
            }
          }
        }
      }
      PHASE_MARK(0);
      group_barrier(counter, ++n_bar * p.P);
      PHASE_MARK(1);

      // The halo row of d (the next slice's first row), then T = d B^T for
      // the own rows and the halo row; Sl and Su to 0.
      if (has_next)
        for (int idx = tid; idx < chains * w; idx += kThreads) {
          const int c = idx / w, x = idx - c * w;
          CHN(c)[nr * w + x] = __ldcg(dh + (gc0 + c) * hw + (size_t)r1 * w + x);
        }
      for (int idx = tid; idx < chains * (2 * nr + 1) * W; idx += kThreads) {
        const int c = idx / ((2 * nr + 1) * W);
        const int rem = idx - c * (2 * nr + 1) * W;  // Sl rows 0..nr, then Su rows 0..nr-1
        CHN(c)[rem < (nr + 1) * W ? L.Sl + rem : L.Su + rem - (nr + 1) * W] = 0.0f;
      }
      __syncthreads();
      for (int idx = tid; idx < chains * nT * W; idx += kThreads) {
        const int c = idx / (nT * W);
        const int rem = idx - c * nT * W;
        const int kk = rem / W, jj = rem - kk * W;
        const int lo = tab[ca.lo + jj];
        const float w0 = TAPW(ca.w0 + jj), w1 = TAPW(ca.w1 + jj);
        const float* drow = CHN(c) + kk * w;
        CHN(c)[L.T + rem] = fmaf(w1, drow[lo + (w1 != 0.0f)], __fmul_rn(w0, drow[lo]));
      }
      __syncthreads();
      PHASE_MARK(2);

      // D = A T and g, and their A^T g terms: a thread per output column
      // walks the chains' output rows in order, adding w0 g into Su of the
      // row's lower tap and w1 g into Sl of its upper tap (lower taps do not
      // decrease, so each sum is kept in a register until its tap changes).
      for (int jj = tid; jj < W; jj += kThreads)
        for (int c = 0; c < chains; ++c) {
          const float* T = CHN(c) + L.T;
          float* su_row = CHN(c) + L.Su + jj;
          float* sl_row = CHN(c) + L.Sl + jj;
          const float* pw_col = pws + ((gc0 + c) * H) * W + jj;
          int cur = -1;
          float su = 0.0f, sl = 0.0f;
#pragma unroll 4
          for (int i = i0; i < i1; ++i) {
            const int lo = tab[ra.lo + i] - r0;
            const float w0 = TAPW(ra.w0 + i), w1 = TAPW(ra.w1 + i);
            const float D = fmaf(w1, T[(lo + (w1 != 0.0f)) * W + jj], __fmul_rn(w0, T[lo * W + jj]));
            const float pv = __ldg(pw_col + (size_t)i * W);
            // g = |pv| (sigmoid(D) - 1/2) + pv/2 = pv * sigmoid(sign(pv) D): one
            // rounding where sigmoid saturates, not a difference of near-equal terms
            const float g = __fmul_rn(pv, __frcp_rn(__fadd_rn(1.0f, expf(pv < 0.0f ? D : -D))));
            if (lo != cur) {
              if (cur >= 0) {
                su_row[cur * W] = su;
                sl_row[(cur + 1) * W] = sl;
              }
              cur = lo;
              su = sl = 0.0f;
            }
            su = fmaf(w0, g, su);
            if (w1 != 0.0f) sl = fmaf(w1, g, sl);
          }
          if (cur >= 0) {
            su_row[cur * W] = su;
            sl_row[(cur + 1) * W] = sl;
          }
        }
      PHASE_MARK(3);
      // Sl of the next slice's first row is that slice's halo.
      __syncthreads();
      if (has_next)
        for (int idx = tid; idx < chains * W; idx += kThreads) {
          const int c = idx / W, jj = idx - c * W;
          __stcg(gbh + ((gc0 + c) * h + r1) * W + jj, CHN(c)[L.Sl + nr * W + jj]);
        }
      PHASE_MARK(4);
      group_barrier(counter, ++n_bar * p.P);
      PHASE_MARK(5);

      // Sl of the own first row from the previous slice, then
      // G = (A^T g) B = (Sl + Su) B for the own rows.
      if (has_prev)
        for (int idx = tid; idx < chains * W; idx += kThreads) {
          const int c = idx / W, jj = idx - c * W;
          CHN(c)[L.Sl + jj] = __ldcg(gbh + ((gc0 + c) * h + r0) * W + jj);
        }
      __syncthreads();
      for (int idx = tid; idx < chains * nr * w; idx += kThreads) {
        const int c = idx / (nr * w), rem = idx - c * nr * w;
        const int kk = rem / w, x = rem - kk * w;
        const int jb = tab[ca.begin + x], je = tab[ca.end + x];
        const float* sl = CHN(c) + L.Sl + kk * W;
        const float* su = CHN(c) + L.Su + kk * W;
        float v = 0.0f;
        for (int jj = jb; jj < je; ++jj) {
          const float wt = tab[ca.lo + jj] == x ? TAPW(ca.w0 + jj) : TAPW(ca.w1 + jj);
          v = fmaf(wt, __fadd_rn(sl[jj], su[jj]), v);
        }
        CHN(c)[L.G + rem] = v;
      }
      __syncthreads();
      PHASE_MARK(6);

      // Partial acc of each own feature row: four threads per float4 of
      // channels take the row's pixels x = sub, sub + 4, ... of every shot,
      // then add up pairwise.
#pragma unroll
      for (int t = 0; t < TILE; ++t)
        for (int kk = 0; kk < nr; ++kk) {
          float4 a = zero4(), ac = zero4();
          if (cg_ok)
            for (int s = 0; s < shot; ++s) {
              const int c = t * shot + s;
              const float4* gf =
                  reinterpret_cast<const float4*>(fs + ((gc0 + c) * hw + (size_t)r0 * w) * C);
              const float4* sf = reinterpret_cast<const float4*>(smem + L.f + (size_t)c * p.pin * C);
              const float* G = CHN(c) + L.G + kk * w;
              // the row's pinned pixels from shared memory, then the rest
              const int xp = min(w, max(0, npin - kk * w));
              int x = sub;
#pragma unroll 4
              for (; x < xp; x += 4) {
                const float4 fv = sf[(size_t)(kk * w + x) * C4 + cg];
                const float gv = G[x];
                dot2_acc(a.x, ac.x, gv, fv.x);
                dot2_acc(a.y, ac.y, gv, fv.y);
                dot2_acc(a.z, ac.z, gv, fv.z);
                dot2_acc(a.w, ac.w, gv, fv.w);
              }
#pragma unroll 4
              for (; x < w; x += 4) {
                const float4 fv = __ldg(gf + (size_t)(kk * w + x) * C4 + cg);
                const float gv = G[x];
                dot2_acc(a.x, ac.x, gv, fv.x);
                dot2_acc(a.y, ac.y, gv, fv.y);
                dot2_acc(a.z, ac.z, gv, fv.z);
                dot2_acc(a.w, ac.w, gv, fv.w);
              }
            }
          a = quad_sum(a, ac);
          if (sub == 0 && cg_ok) __stcg(part4 + ((size_t)(e0 + t) * h + r0 + kk) * C4 + cg, a);
        }
      PHASE_MARK(7);
      group_barrier(counter, ++n_bar * p.P);
      PHASE_MARK(8);

      // acc += the h row partials in a fixed order (rows k = sub, sub + 4,
      // ... in sequence, then pairwise), the same in every CTA; u from acc.
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        float4 v = zero4(), vc = zero4();
        if (cg_ok)
          for (int k = sub; k < h; k += 4) {
            const float4 pk = __ldcg(part4 + ((size_t)(e0 + t) * h + k) * C4 + cg);
            two_sum_acc(v.x, vc.x, pk.x);
            two_sum_acc(v.y, vc.y, pk.y);
            two_sum_acc(v.z, vc.z, pk.z);
            two_sum_acc(v.w, vc.w, pk.w);
          }
        v = quad_sum(v, vc);
        if (sub == 0 && cg_ok) {
          float4* acc4 = reinterpret_cast<float4*>(EPI(t) + L.acc);
          float4* u4 = reinterpret_cast<float4*>(EPI(t));
          const float4 a = add4(acc4[cg], v);
          const float4 b = __ldg(reinterpret_cast<const float4*>(u0 + (size_t)(e0 + t) * C) + cg);
          acc4[cg] = a;
          u4[cg] = make_float4(fmaf(-scale, a.x, b.x), fmaf(-scale, a.y, b.y),
                               fmaf(-scale, a.z, b.z), fmaf(-scale, a.w, b.w));
        }
      }
      __syncthreads();
      PHASE_MARK(9);
    }

    if (j == 0) {
      for (int t = 0; t < TILE; ++t)
        for (int k = tid; k < C; k += kThreads) acc_out[(size_t)(e0 + t) * C + k] = EPI(t)[L.acc + k];
    }
    __syncthreads();
  }
#undef EPI
#undef CHN
#undef TAPW
#ifdef FSS_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&fss_phase_cycles_dev[i], ph[i]);
#endif
}

// K1: TILE 1, any shot.
__global__ void __launch_bounds__(kThreads, 1)
adapt_binary_kernel(const float* __restrict__ fs,    // (E, shot, h*w, C)
                    const float* __restrict__ pws,   // (E, shot, H, W)
                    const float* __restrict__ u0,    // (E, C)
                    const int* __restrict__ taps,    // tap tables (ops/inner_loop_plan.py)
                    float* dh,                       // (E*shot, h, w): d halo rows
                    float* gbh,                      // (E*shot, h, W): A^T g halo rows
                    float* part,                     // (E, h, C): row partials of acc
                    unsigned* counters,              // (n_conc,) zeroed barrier counters
                    float* __restrict__ acc_out,     // (E, C)
                    Params p) {
  adapt_binary_body<1>(fs, pws, u0, taps, dh, gbh, part, counters, acc_out, p);
}

// K2: TILE 1-shot episodes per CTA, same arguments.
template <int TILE>
__global__ void __launch_bounds__(kThreads, 1)
adapt_binary_tiled_kernel(const float* __restrict__ fs, const float* __restrict__ pws,
                          const float* __restrict__ u0, const int* __restrict__ taps,
                          float* dh, float* gbh, float* part, unsigned* counters,
                          float* __restrict__ acc_out, Params p) {
  adapt_binary_body<TILE>(fs, pws, u0, taps, dh, gbh, part, counters, acc_out, p);
}

typedef void (*KernelFn)(const float*, const float*, const float*, const int*, float*, float*,
                         float*, unsigned*, float*, Params);

KernelFn kernel_for(int tile) {
  switch (tile) {
    case 1: return adapt_binary_kernel;
    case 2: return adapt_binary_tiled_kernel<2>;
    case 3: return adapt_binary_tiled_kernel<3>;
    case 4: return adapt_binary_tiled_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for these sizes, in bytes.
size_t fss_adapt_binary_smem_bytes(int h, int w, int C, int H, int W, int shot, int tile,
                                   int rows, int pin) {
  return make_layout(h, w, C, H, W, shot, tile, rows, pin).total_floats * sizeof(float);
}

// SMs of the current device into *out; returns the cudaError_t.
int fss_sm_count(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
}

// CTAs of the kernel for `tile` one SM holds at `smem` bytes, into *out.
int fss_blocks_per_sm(int tile, size_t smem, int* out) {
  KernelFn fn = kernel_for(tile);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, (const void*)fn, kThreads, smem);
}

// Launches the inner loop for E episodes on `stream` as a cooperative grid
// of n_conc * P CTAs (K1 for tile 1, else K2 with `tile` episodes a CTA);
// returns the cudaError_t of the launch (0 on success; the card refuses a
// grid it cannot hold at once). Does not synchronise.
int fss_adapt_binary(const float* fs, const float* pws, const float* u0, const int* taps,
                     float* dh, float* gbh, float* part, unsigned* counters, float* acc,
                     int E, int shot, int h, int w, int C, int H, int W, int num_steps,
                     float lr, int tile, int P, int n_conc, int rows, int pin,
                     void* stream) {
  KernelFn fn = kernel_for(tile);
  if (fn == nullptr || E < 1 || E % tile != 0 || shot < 1 || (tile > 1 && shot != 1) ||
      C % 4 != 0 || C > 4 * kMaxC4 || P < 1 || P > h || rows != (h + P - 1) / P ||
      n_conc < 1 || pin < 0 || num_steps < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{E, shot, h, w, C, H, W, num_steps, lr, P, n_conc, rows, pin};
  const size_t smem = fss_adapt_binary_smem_bytes(h, w, C, H, W, shot, tile, rows, pin);
  cudaError_t err = cudaFuncSetAttribute((const void*)fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params pp = p;
  void* args[] = {(void*)&fs, (void*)&pws, (void*)&u0, (void*)&taps, (void*)&dh,
                  (void*)&gbh, (void*)&part, (void*)&counters, (void*)&acc, (void*)&pp};
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(n_conc * P), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef FSS_PHASE_CLOCKS
// Copies the per-phase cycle sums over all CTAs of the launches since the
// last call into out[10] and zeroes them; returns the cudaError_t.
int fss_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fss_phase_cycles_dev, sizeof(fss_phase_cycles_dev));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[kPhases] = {};
  return (int)cudaMemcpyToSymbol(fss_phase_cycles_dev, zeros, sizeof(zeros));
}
#endif

const char* fss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
