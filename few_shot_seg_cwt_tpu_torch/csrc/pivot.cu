// Centre-pivot 4D convolution on flat correlation volumes, on Hopper (sm_90a).
//
// Replaces both TPU formulations of the NeighConsensus pivot pair, which
// share one function and one contract (few_shot_seg_cwt_tpu/ops/
// pallas_pivot_mxu.py:24-27):
//
//   pivot_fwd  <- `_mxu_fwd_kernel` (ops/pallas_pivot_mxu.py, MXU form) and
//                 `_pivot_fwd_kernel` (ops/pallas_pivot.py, VPU form);
//   pivot_dw   <- `_mxu_dw_kernel` (ops/pallas_pivot_mxu.py) and
//                 `_pivot_dw_kernel` (ops/pallas_pivot.py).
//
// Layout: a volume is channels-major (B, C, Q, S) fp32, Q = hq*wq query
// positions, S = hs*ws support positions (get_corr's natural layout).
//
// pivot_fwd (pivot_fwd.cuh, with its own note): y = the 3x3 conv over the
// query plane + the 3x3 conv over the support plane + bias [+ ReLU], on the
// CUDA cores in fp32, from a staged query window with P positions and all
// Co outputs a thread.
//
// pivot_dw: the weight and bias gradients of the pair, summed over every
// (b, q, s), at most 18*Ci*Co + Co = 1810 outputs from a 13 M-long
// contraction at 473 px:
//
//   dwa[d,ci,co] = sum x[ci, q+d, s] g[co,q,s],  dwb likewise over support
//   shifts, db[co] = sum g[co,q,s].
//
// As a GEMM: dW^T (18*Ci+1 x Co) = A (18*Ci+1 x P) . G^T (P x Co) over the
// positions P, where row (tap, ci) of A is x shifted by the tap and the
// extra row is all ones (it gives db). M is padded to m16 tiles (36+1 -> 48
// rows at Ci = 2, 180+1 -> 192 at Ci = 10), N = Co to n8 tiles.
//
// What bounds it, at 473 px on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on
// the CUDA cores, 495 TFLOP/s TF32 on the tensor cores): 10->10 is 46.66
// GFLOP, 0.696 ms on the CUDA cores but 3 x 46.66 GFLOP = 0.283 ms as 3xTF32
// on the tensor cores, under its 1.037 GB = 0.310 ms of bytes; 2->10 and
// 10->1 are bound by bytes (0.186, 0.170 ms). So the work goes to the
// tensor cores and the kernel must stream x and g about once. The first
// design (CUDA-core FMAs on an im2col built one element at a time in shared
// memory, three integer divisions and a scalar load per element) took
// 20.3 ms at 10->10: its time scaled with the im2col, not the FMAs.
//
// The design: stage rows, not an im2col.
//  - Work: a step is (b, query row qi, a tile of DW_ROWS whole support rows,
//    query column qj), K = DW_ROWS*ws positions. The steps are numbered
//    with qj fastest and a persistent grid (one 16-warp CTA an SM) takes
//    contiguous runs of them, so a CTA walks qj along one query row.
//  - Query taps: the CTA keeps the 3x3 window of query positions
//    (qi-1..qi+1, qj-1..qj+1) x Ci x tile in shared memory, in a ring of
//    DW_SLOTS columns; a step stages only the new column qj+1 (3 rows x Ci
//    x tile), so x is read about 3 times, not 9. A query row or column
//    outside the plane is never staged: its rows of A read a zero region.
//  - Support taps: the centre row of each column is staged with its halo,
//    (DW_ROWS+2) rows with a zero column each side, so a support tap is a
//    constant offset into that buffer, with no edge test.
//  - Staging: half a warp copies a row with 16-byte cp.async (4-byte where
//    ws or the pointers are not 16-byte aligned), from a table of rows
//    built once a CTA; no division per element. The next step's column and
//    g tile are in flight while this step is split and multiplied (the
//    ring's fourth slot, g's second buffer).
//  - 3xTF32: each landed value is split once, in place, into big =
//    cvt.rna.tf32(a) and small = cvt.rna.tf32(a - big), kept side by side
//    (`split` floats apart); mma.sync.m16n8k8 TF32 then issues big.big +
//    big.small + small.big (small.small is dropped), which keeps fp32
//    accuracy. Splitting at the fragment loads instead converts each value
//    once for every tap that reads it.
//  - Fragment loads: every row of A is (a base that changes once a step) +
//    pos[p], one table mapping position p to its staged offset. Ragged
//    widths (ws = 60 is no multiple of 8): K is padded to a multiple of 8
//    with g = 0 (the padded positions read a real staged value of x).
//  - A warp owns 3 m-tiles and every n-tile for a share of the k-chunks;
//    its fragments accumulate one step, then are added to per-thread
//    running sums. The warps' sums are added in shared memory in a fixed
//    order, each CTA writes one partial row, and pivot_dw_reduce_kernel sums
//    the rows in order, in double. No atomics: every launch gives the same
//    bits.
// Where a step's time goes (tools/profile_pivot.py --phases, PERF.md): at
// 10->10 about a quarter issuing the copies, a quarter splitting, and the
// rest the MMAs, one after another; the tensor-core work is 3 products
// with N padded to 8 or 16 on mma.sync, well under the wgmma rate the
// 495 TFLOP/s assumes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int DW_THREADS = 512;    // 16 warps, one CTA an SM
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int DW_ROWS = 2;         // support rows per step
constexpr int DW_MT_PER_WARP = 3;  // m16 tiles a warp owns
constexpr int DW_SLOTS = 4;        // columns staged: the window's 3 and the next
constexpr int DW_LEAD = 4;         // a staged row's data starts 16-byte aligned
constexpr int MAX_CO = 10;
constexpr int DW_MAX_CI = 42;      // 18*42+1 rows: 48 m-tiles, 16 warp groups
constexpr size_t DEFAULT_SMEM = 48 * 1024;

// ---- pivot_dw ------------------------------------------------------------

// A stride of 4 * odd floats puts 8 consecutive channels on 8 distinct
// 4-bank groups: the lanes of a fragment load do not collide.
__host__ __device__ inline int pad_banks(int n) { return n + ((12 - n % 8) % 8); }

// Shared-memory layout of pivot_dw_mma_kernel, in floats (the same on the
// host and the device). Every A source (the zero region, the ones region,
// the ring of staged columns) holds TF32 "big" parts; its "small" parts sit
// `split` floats later. Offsets are multiples of 4 (16-byte copies).
struct DwLayout {
  int ldw;       // staged row stride; the row's data starts at DW_LEAD, with
                 // zeros at DW_LEAD - 1 and DW_LEAD + ws
  int csq, csc;  // per-channel stride: query-row buffers (DW_ROWS rows) and
                 // centre-row buffers (DW_ROWS + 2 rows, with the halo)
  int slot;      // one column of the window: 3 query rows x ci channels
  int zr;        // the zero region and the ones region, zr floats each
  int xs;        // offset of the ring of DW_SLOTS columns
  int split;     // big part -> small part
  int kp, ldg;   // positions a step (K, a multiple of 8) and g's row stride
  int gsmall;    // g: big rows, then small rows gsmall floats later
  int gs;        // offset of g's two buffers, 2 * gsmall floats each
  int pos;       // offset of the position table (kp ints)
  int rows_x, rows_g;  // rows staged for one column; for g
  int rowtab;    // offset of the staging table: 3 ints a row
  int mg, ks;    // warp groups of DW_MT_PER_WARP m16 tiles; k-splits
  int n_out;     // (18*ci + 1) * co: dW then db
  int floats;    // staging, or the warps' partial sums at the end
};

__host__ __device__ inline DwLayout dw_layout(int ci, int co, int ws) {
  DwLayout l;
  l.ldw = (ws + DW_LEAD + 1 + 3) / 4 * 4;
  l.csq = pad_banks(DW_ROWS * l.ldw);
  l.csc = pad_banks((DW_ROWS + 2) * l.ldw);
  l.slot = ci * (2 * l.csq + l.csc);
  l.zr = (DW_ROWS + 2) * l.ldw;
  l.xs = 2 * l.zr;
  l.split = l.xs + DW_SLOTS * l.slot;
  l.kp = (DW_ROWS * ws + 7) / 8 * 8;
  l.ldg = pad_banks(l.kp);
  l.gsmall = (co + 7) / 8 * 8 * l.ldg;
  l.gs = 2 * l.split;
  l.pos = l.gs + 4 * l.gsmall;
  l.rows_x = ci * (3 * DW_ROWS + 2);
  l.rows_g = co * DW_ROWS;
  l.rowtab = l.pos + l.kp;
  const int m_tiles = (18 * ci + 1 + 15) / 16;
  l.mg = (m_tiles + DW_MT_PER_WARP - 1) / DW_MT_PER_WARP;
  l.ks = l.mg <= DW_WARPS ? DW_WARPS / l.mg : 0;
  l.n_out = (18 * ci + 1) * co;
  const int staging = l.rowtab + 3 * (l.rows_x + l.rows_g);
  const int partials = l.ks * l.n_out;
  l.floats = staging > partials ? staging : partials;
  return l;
}

__device__ __forceinline__ uint32_t tf32_bits(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// a = big + small, both TF32 (the low 13 bits zero): 3xTF32's split.
__device__ __forceinline__ void split_tf32(float a, float& big, float& small) {
  big = __uint_as_float(tf32_bits(a));
  small = __uint_as_float(tf32_bits(a - big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copies to shared memory (4 or 16 bytes); zero-fill when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// ---- pivot_fwd -----------------------------------------------------------

#ifdef FSS_PHASE_CLOCKS
// Built with -DFSS_PHASE_CLOCKS, thread 0 of each CTA reads clock64() at the
// end of every phase of a step (after the barrier that closes it) and adds
// the cycles to its CTA's row, read by fss_pivot_fwd_phase_cycles(): issuing
// the next step's copies, waiting for this step's, computing, staging a
// fresh run's window.
constexpr int kFwdPhases = 4;
constexpr int kFwdMaxCtas = 1024;
__device__ unsigned long long fss_fwd_phase_cycles_dev[kFwdMaxCtas][kFwdPhases];
#define FWD_PHASE_START()                      \
  unsigned long long ph[kFwdPhases] = {};      \
  long long t_last = clock64()
#define FWD_PHASE(i)                                 \
  do {                                               \
    if (tid == 0) {                                  \
      const long long now = clock64();               \
      ph[i] += (unsigned long long)(now - t_last);   \
      t_last = now;                                  \
    }                                                \
  } while (0)
#define FWD_PHASE_END()                                                           \
  if (tid == 0 && blockIdx.x < kFwdMaxCtas)                                       \
    for (int i = 0; i < kFwdPhases; ++i) fss_fwd_phase_cycles_dev[blockIdx.x][i] += ph[i]
#else
#define FWD_PHASE_START() \
  do {                    \
  } while (0)
#define FWD_PHASE(i) \
  do {               \
  } while (0)
#define FWD_PHASE_END() \
  do {                  \
  } while (0)
#endif

// TMA bulk copies from global to shared memory that complete on an mbarrier
// (its transaction count), and the barrier's operations.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Spins until the phase of `parity` completes; traps after ~10 s (a byte
// count that never completes would otherwise hang the card).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy_g2s(float* dst, const float* src, unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

#define FSS_SHARED(name) extern __shared__ float name[]
#include "pivot_fwd.cuh"

// ---- pivot_dw: staging ---------------------------------------------------

// What one step stages: its query columns c_lo..c_hi and g's tile.
struct DwStep {
  int b, qi, qj, u0, c_lo, c_hi;
};

// Copy (stage) or split in place (convert) every row of a step: half a warp
// a row, the row's source and destination from the CTA's staging table.
// Rows of query rows outside the plane are skipped (never read); rows
// outside the support plane are zero-filled.
template <int CO, bool STAGE>
__device__ __forceinline__ void dw_rows(const DwLayout& L, float* smem, const float* x,
                                        const float* g, float* gb, const DwStep& st,
                                        int ci_n, int hq, int wq, int hs, int ws, bool vec) {
  const int* tab = reinterpret_cast<const int*>(smem + L.rowtab);
  const int lane = threadIdx.x & 31;
  const int rid = (threadIdx.x >> 5) * 2 + (lane >> 4), l16 = lane & 15;
  const int S = hs * ws, Q = hq * wq;
  const int n_cols = st.c_hi >= st.c_lo ? st.c_hi - st.c_lo + 1 : 0;
  const int n_rows = n_cols * L.rows_x + L.rows_g;
  int col = 0, j = rid;  // rows walk column after column, then g's
  while (j >= L.rows_x && col < n_cols) {
    j -= L.rows_x;
    ++col;
  }
  for (int r = rid; r < n_rows; r += 2 * DW_WARPS) {
    const bool is_g = col == n_cols;
    const int* e = tab + 3 * (is_g ? L.rows_x + j : j);
    const int rr = e[2] & 3, uu = (e[2] >> 2) - 1;
    const int qc = st.c_lo + col;
    float* dst;
    const float* base;
    if (is_g) {
      dst = gb + e[0];
      base = g + ((size_t)st.b * CO * Q + (size_t)st.qi * wq + st.qj) * S;
    } else {
      dst = smem + L.xs + (qc % DW_SLOTS) * L.slot + e[0];
      base = x + ((size_t)st.b * ci_n * Q + (size_t)st.qi * wq + qc) * S;
    }
    const int qrow = st.qi + rr - 1, u = st.u0 + uu;
    if (qrow >= 0 && qrow < hq) {
      const bool in = u >= 0 && u < hs;
      const float* src = in ? base + (ptrdiff_t)e[1] + (size_t)st.u0 * ws : x;
      const int small = is_g ? L.gsmall : L.split;
      if (vec) {
        for (int v = 4 * l16; v < ws; v += 64) {
          if (STAGE) {
            cp_async16(dst + v, src + (in ? v : 0), in);
          } else {
            float4 a = *reinterpret_cast<float4*>(dst + v), hi, lo;
            split_tf32(a.x, hi.x, lo.x);
            split_tf32(a.y, hi.y, lo.y);
            split_tf32(a.z, hi.z, lo.z);
            split_tf32(a.w, hi.w, lo.w);
            float4* d4 = reinterpret_cast<float4*>(dst + v);
            d4[0] = hi;
            d4[small / 4] = lo;  // small is a multiple of 4
          }
        }
      } else {
        for (int v = l16; v < ws; v += 16) {
          if (STAGE) {
            cp_async4(dst + v, src + (in ? v : 0), in);
          } else {
            float hi, lo;
            split_tf32(dst[v], hi, lo);
            dst[v] = hi;
            dst[v + small] = lo;
          }
        }
      }
    }
    j += 2 * DW_WARPS;
    while (j >= L.rows_x && col < n_cols) {
      j -= L.rows_x;
      ++col;
    }
  }
}

#ifdef FSS_PHASE_CLOCKS
// Built with -DFSS_PHASE_CLOCKS, thread 0 of each CTA reads clock64() at the
// end of every phase of a step (after the barrier that closes it) and adds
// the cycles to its CTA's row of counters, read by
// fss_pivot_dw_phase_cycles(): issuing the next step's copies, waiting for
// this step's, splitting them, the MMAs, and staging a fresh run's columns.
constexpr int kDwPhases = 5;
constexpr int kDwMaxCtas = 1024;
__device__ unsigned long long fss_dw_phase_cycles_dev[kDwMaxCtas][kDwPhases];
#define DW_PHASE(i)                                \
  do {                                             \
    if (tid == 0) {                                \
      const long long now = clock64();             \
      ph[i] += (unsigned long long)(now - t_last); \
      t_last = now;                                \
    }                                              \
  } while (0)
#else
#define DW_PHASE(i) \
  do {              \
  } while (0)
#endif

template <int CO>
__global__ void __launch_bounds__(DW_THREADS, 1)
pivot_dw_mma_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ partial, int ci_n, int hq, int wq, int hs, int ws,
                    int batch, int vec) {
  constexpr int NT = (CO + 7) / 8;           // n8 tiles
  extern __shared__ float smem[];
  const DwLayout L = dw_layout(ci_n, CO, ws);
  int* pos = reinterpret_cast<int*>(smem + L.pos);
  int* tab = reinterpret_cast<int*>(smem + L.rowtab);
  const int S = hs * ws, Q = hq * wq;
  const int tiles = (hs + DW_ROWS - 1) / DW_ROWS;
  const long long steps = (long long)batch * hq * tiles * wq;
  const long long t_begin = steps * blockIdx.x / gridDim.x;
  const long long t_end = steps * (blockIdx.x + 1) / gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the mma fragments' row / column

  for (int i = tid; i < L.floats; i += DW_THREADS) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < L.zr; i += DW_THREADS) smem[L.zr + i] = 1.f;
  for (int p = tid; p < L.kp; p += DW_THREADS) {
    const int uu = p / ws;  // once a CTA
    pos[p] = p < DW_ROWS * ws ? (uu + 1) * L.ldw + DW_LEAD + (p - uu * ws) : L.ldw + DW_LEAD;
  }
  // the staging table, once a CTA: destination (from the column's slot or
  // g's buffer), source (from the step's column or g's row at support row
  // u0), and (query row 0-2, support row + 1)
  for (int j = tid; j < L.rows_x + L.rows_g; j += DW_THREADS) {
    int* e = tab + 3 * j;
    if (j < L.rows_x) {
      const int c = j / (3 * DW_ROWS + 2), k = j - c * (3 * DW_ROWS + 2);
      const int rr = k < DW_ROWS ? 0 : (k < 2 * DW_ROWS + 2 ? 1 : 2);
      const int uu = rr == 0 ? k : (rr == 1 ? k - DW_ROWS - 1 : k - 2 * DW_ROWS - 2);
      const int roff = rr == 0 ? 0 : (rr == 1 ? ci_n * L.csq : ci_n * (L.csq + L.csc));
      e[0] = roff + c * (rr == 1 ? L.csc : L.csq) + (rr == 1 ? uu + 1 : uu) * L.ldw + DW_LEAD;
      e[1] = c * Q * S + (rr - 1) * wq * S + uu * ws;
      e[2] = rr | ((uu + 1) << 2);
    } else {
      const int co = (j - L.rows_x) / DW_ROWS, uu = j - L.rows_x - co * DW_ROWS;
      e[0] = co * L.ldg + uu * ws;
      e[1] = co * Q * S + uu * ws;
      e[2] = 1 | ((uu + 1) << 2);
    }
  }

  // the warp's share: m-tiles mg*3 .. mg*3+2 for k-chunks ks, ks+KS, ...
  const int mg = L.ks ? warp / L.ks : DW_WARPS;
  const int ks = L.ks ? warp - mg * L.ks : 0;
  const bool mma_warp = mg < L.mg;
  // the taps of this thread's 6 rows of A: 0-8 query, 9-17 support, 18 the
  // ones row, 19 padding; and their channel
  int tap[DW_MT_PER_WARP][2], chan[DW_MT_PER_WARP][2];
#pragma unroll
  for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mg * DW_MT_PER_WARP + mt) * 16 + grp + 8 * h;
      tap[mt][h] = m < 18 * ci_n ? m / ci_n : (m == 18 * ci_n ? 18 : 19);
      chan[mt][h] = m < 18 * ci_n ? m - (m / ci_n) * ci_n : 0;
    }

  float run[DW_MT_PER_WARP][NT][4];
#pragma unroll
  for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[mt][nt][i] = 0.f;

  // decode the first step once; later steps advance qj, then the tile, qi, b
  long long r = t_begin;
  int qj = (int)(r % wq);
  r /= wq;
  int tile = (int)(r % tiles);
  r /= tiles;
  int qi = (int)(r % hq);
  int b = (int)(r / hq);
  __syncthreads();

  // Pipeline, one step ahead: while step t is split and its MMAs run, step
  // t+1's new column and g tile are in flight (cp.async into the ring's
  // fourth slot and g's other buffer). A step that starts a new run of qj
  // (qj = 0) stages its 2 columns after step t's MMAs, whose slots it may
  // reuse. Each landed row is split in place once (big, small), so the
  // fragment loads do no conversion.
#ifdef FSS_PHASE_CLOCKS
  unsigned long long ph[kDwPhases] = {};
  long long t_last = clock64();
#endif
  int gsel = 0;
  DwStep cur = {b, qi, qj, tile * DW_ROWS, max(qj - 1, 0), min(qj + 1, wq - 1)};
  if (t_begin < t_end) {
    dw_rows<CO, true>(L, smem, x, g, smem + L.gs, cur, ci_n, hq, wq, hs, ws, vec);
    cp_async_commit();
  }
  for (long long t = t_begin; t < t_end; ++t) {
    int nqj = qj + 1, ntile = tile, nqi = qi, nb = b;
    if (nqj == wq) {
      nqj = 0;
      if (++ntile == tiles) {
        ntile = 0;
        if (++nqi == hq) {
          nqi = 0;
          ++nb;
        }
      }
    }
    const bool has_next = t + 1 < t_end;
    float* g_cur = smem + L.gs + gsel * 2 * L.gsmall;
    float* g_next = smem + L.gs + (gsel ^ 1) * 2 * L.gsmall;
    const DwStep next = {nb, nqi, nqj, ntile * DW_ROWS, nqj == 0 ? 0 : nqj + 1,
                         min(nqj + 1, wq - 1)};
    if (has_next && nqj != 0) {
      dw_rows<CO, true>(L, smem, x, g, g_next, next, ci_n, hq, wq, hs, ws, vec);
      cp_async_commit();
      DW_PHASE(0);
      cp_async_wait<1>();
    } else {
      DW_PHASE(0);
      cp_async_wait<0>();
    }
    __syncthreads();
    DW_PHASE(1);
    dw_rows<CO, false>(L, smem, x, g, g_cur, cur, ci_n, hq, wq, hs, ws, vec);
    __syncthreads();
    DW_PHASE(2);

    if (mma_warp) {
      // this step's base offset of each of the thread's rows of A
      const int s_prev = (qj + DW_SLOTS - 1) % DW_SLOTS, s_mid = qj % DW_SLOTS,
                s_next = (qj + 1) % DW_SLOTS;
      int base[DW_MT_PER_WARP][2];
#pragma unroll
      for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tp = tap[mt][h], c = chan[mt][h];
          int o = 0;  // the zero region
          if (tp < 9) {
            const int dh = tp / 3 - 1, dw = tp % 3 - 1;
            if (qi + dh >= 0 && qi + dh < hq && qj + dw >= 0 && qj + dw < wq) {
              const int s = dw < 0 ? s_prev : (dw == 0 ? s_mid : s_next);
              o = L.xs + s * L.slot +
                  (dh < 0 ? c * L.csq - L.ldw
                          : (dh == 0 ? ci_n * L.csq + c * L.csc
                                     : ci_n * (L.csq + L.csc) + c * L.csq - L.ldw));
            }
          } else if (tp < 18) {
            const int du = (tp - 9) / 3 - 1, dv = (tp - 9) % 3 - 1;
            o = L.xs + s_mid * L.slot + ci_n * L.csq + c * L.csc + du * L.ldw + dv;
          } else if (tp == 18) {
            o = L.zr;  // the ones region: this row gives db
          }
          base[mt][h] = o;
        }

      float acc[DW_MT_PER_WARP][NT][4];
#pragma unroll
      for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

      for (int k0 = ks * 8; k0 < L.kp; k0 += L.ks * 8) {
        const int p0 = pos[k0 + tig], p1 = pos[k0 + tig + 4];
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* gr = g_cur + (nt * 8 + grp) * L.ldg + k0 + tig;
          bb[nt][0] = __float_as_uint(gr[0]);
          bb[nt][1] = __float_as_uint(gr[4]);
          bs[nt][0] = __float_as_uint(gr[L.gsmall]);
          bs[nt][1] = __float_as_uint(gr[L.gsmall + 4]);
        }
        // all three m-tiles' fragments first (a padding tile reads the
        // zero region), then the MMAs product by product, so that the
        // three MMAs into one accumulator are 3 * NT apart, not adjacent
        uint32_t ab[DW_MT_PER_WARP][4], as[DW_MT_PER_WARP][4];
#pragma unroll
        for (int mt = 0; mt < DW_MT_PER_WARP; ++mt) {
          const float* a0 = smem + base[mt][0];
          const float* a1 = smem + base[mt][1];
          ab[mt][0] = __float_as_uint(a0[p0]);
          ab[mt][1] = __float_as_uint(a1[p0]);
          ab[mt][2] = __float_as_uint(a0[p1]);
          ab[mt][3] = __float_as_uint(a1[p1]);
          as[mt][0] = __float_as_uint(a0[p0 + L.split]);
          as[mt][1] = __float_as_uint(a1[p0 + L.split]);
          as[mt][2] = __float_as_uint(a0[p1 + L.split]);
          as[mt][3] = __float_as_uint(a1[p1 + L.split]);
        }
#pragma unroll
        for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
        for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
        for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) run[mt][nt][i] += acc[mt][nt][i];
    }
    __syncthreads();  // the step after next reuses this step's slots and g buffer
    DW_PHASE(3);
    if (has_next && nqj == 0) {
      dw_rows<CO, true>(L, smem, x, g, g_next, next, ci_n, hq, wq, hs, ws, vec);
      cp_async_commit();
    }
    DW_PHASE(4);
    cur = next;
    qj = nqj;
    tile = ntile;
    qi = nqi;
    b = nb;
    gsel ^= 1;
  }

#ifdef FSS_PHASE_CLOCKS
  if (tid == 0 && blockIdx.x < kDwMaxCtas)
    for (int i = 0; i < kDwPhases; ++i) fss_dw_phase_cycles_dev[blockIdx.x][i] += ph[i];
#endif
  // the k-splits' sums, added in a fixed order into the CTA's partial row
  float* red = smem;
  if (mma_warp) {
#pragma unroll
    for (int mt = 0; mt < DW_MT_PER_WARP; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // padding rows and columns are dropped
          const int m = (mg * DW_MT_PER_WARP + mt) * 16 + grp + (i >= 2 ? 8 : 0);
          const int co = nt * 8 + 2 * tig + (i & 1);
          if (m <= 18 * ci_n && co < CO) red[ks * L.n_out + m * CO + co] = run[mt][nt][i];
        }
  }
  __syncthreads();
  for (int j = tid; j < L.n_out; j += DW_THREADS) {
    float sum = 0.f;
    for (int k = 0; k < L.ks; ++k) sum += red[k * L.n_out + j];
    partial[(size_t)blockIdx.x * L.n_out + j] = sum;
  }
}

__global__ void pivot_dw_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int n_out,
                                       int n_blocks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  double sum = 0.0;
  for (int b = 0; b < n_blocks; ++b) sum += partial[(size_t)b * n_out + j];
  out[j] = (float)sum;
}

// pivot_fwd's layout for a shape: its support rows a tile and shared bytes.
FwdLayout fwd_plan_layout(int ci, int co, int hs, int ws) {
  return fwd_layout(ci, co, ws, fwd_rows(ci, co, hs, ws));
}

size_t fwd_smem_bytes(int ci, int co, int hs, int ws) {
  return sizeof(float) * (size_t)fwd_plan_layout(ci, co, hs, ws).floats;
}

size_t dw_smem_bytes(int ci, int co, int ws) {
  return sizeof(float) * (size_t)dw_layout(ci, co, ws).floats;
}

template <int CO>
cudaError_t dw_prepare(int ci, int ws, size_t* smem) {
  *smem = dw_smem_bytes(ci, CO, ws);
  if (*smem > DEFAULT_SMEM)
    return cudaFuncSetAttribute(pivot_dw_mma_kernel<CO>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

// The persistent grid: every CTA the card holds at once, at most one a step.
template <int CO>
int dw_blocks(int batch, int ci, int hq, int wq, int hs, int ws) {
  size_t smem;
  if (dw_prepare<CO>(ci, ws, &smem) != cudaSuccess) return -1;
  int dev, sms, per_sm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pivot_dw_mma_kernel<CO>,
                                                    DW_THREADS, smem) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long steps =
      (long long)batch * hq * ((hs + DW_ROWS - 1) / DW_ROWS) * wq;
  const long long grid = (long long)sms * per_sm;
  return (int)(steps < grid ? steps : grid);
}

template <int CO>
cudaError_t launch_dw(const float* x, const float* g, float* partial, float* out,
                      int batch, int ci, int hq, int wq, int hs, int ws, int blocks,
                      cudaStream_t stream) {
  if (ci < 1 || ci > DW_MAX_CI || blocks < 1) return cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = dw_prepare<CO>(ci, ws, &smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies where every staged row starts 16-byte aligned
  const int vec = ws % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0;
  pivot_dw_mma_kernel<CO><<<blocks, DW_THREADS, smem, stream>>>(x, g, partial, ci, hq, wq,
                                                               hs, ws, batch, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = 18 * ci * CO + CO;
  pivot_dw_reduce_kernel<<<(n_out + 127) / 128, 128, 0, stream>>>(partial, out, n_out,
                                                                  blocks);
  return cudaGetLastError();
}

// pivot_fwd's persistent grid: every CTA the card holds at once, at most
// one a step. Fills out[4] = {P, support rows a tile, threads, blocks}.
template <int CO>
cudaError_t fwd_plan(int batch, int ci, int hq, int wq, int hs, int ws, int* out) {
  const FwdLayout L = fwd_plan_layout(ci, CO, hs, ws);
  const size_t smem = sizeof(float) * (size_t)L.floats;
  if (ci < 1 || smem > (size_t)FWD_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > DEFAULT_SMEM)
    err = cudaFuncSetAttribute(pivot_fwd_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int dev, sms, per_sm;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pivot_fwd_kernel<CO>, L.threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long steps = (long long)batch * ((hs + L.rows - 1) / L.rows) * hq * wq;
  const long long grid = (long long)sms * per_sm;
  out[0] = L.p;
  out[1] = L.rows;
  out[2] = L.threads;
  out[3] = (int)(steps < grid ? steps : grid);
  return cudaSuccess;
}

template <int CO>
cudaError_t launch_fwd(const float* x, const float* w, const float* bias, float* y,
                       int batch, int ci, int hq, int wq, int hs, int ws, int relu,
                       cudaStream_t stream) {
  int plan[4];
  cudaError_t err = fwd_plan<CO>(batch, ci, hq, wq, hs, ws, plan);
  if (err != cudaSuccess) return err;
  if (plan[3] < 1) return cudaSuccess;  // an empty batch
  const size_t smem = sizeof(float) * (size_t)fwd_layout(ci, CO, ws, plan[1]).floats;
  // bulk copies and vector stores where every row starts 16-byte aligned
  const int bulk = ws % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  pivot_fwd_kernel<CO><<<plan[3], plan[2], smem, stream>>>(x, w, bias, y, ci, hq, wq, hs, ws,
                                                           batch, plan[1], relu, bulk);
  return cudaGetLastError();
}

#define FSS_CO_SWITCH(co, CALL)                                   \
  switch (co) {                                                   \
    case 1: return (int)CALL(1);                                  \
    case 2: return (int)CALL(2);                                  \
    case 3: return (int)CALL(3);                                  \
    case 4: return (int)CALL(4);                                  \
    case 5: return (int)CALL(5);                                  \
    case 6: return (int)CALL(6);                                  \
    case 7: return (int)CALL(7);                                  \
    case 8: return (int)CALL(8);                                  \
    case 9: return (int)CALL(9);                                  \
    case 10: return (int)CALL(10);                                \
    default: return (int)cudaErrorInvalidValue;                   \
  }

}  // namespace

extern "C" {

// Output channels the kernels are instantiated for: 1..fss_pivot_max_co().
int fss_pivot_max_co() { return MAX_CO; }

// Input channels pivot_dw takes: 1..fss_pivot_dw_max_ci().
int fss_pivot_dw_max_ci() { return DW_MAX_CI; }

// Dynamic shared memory per block, in bytes (the wrapper refuses what a
// Hopper block cannot hold).
size_t fss_pivot_fwd_smem_bytes(int ci, int co, int hs, int ws) {
  return fwd_smem_bytes(ci, co, hs, ws);
}
size_t fss_pivot_dw_smem_bytes(int ci, int co, int ws) { return dw_smem_bytes(ci, co, ws); }

// pivot_dw's grid on the current device (-1 if the card holds no CTA): the
// scratch holds blocks * (18*ci*co + co) floats.
int fss_pivot_dw_blocks(int batch, int ci, int co, int hq, int wq, int hs, int ws) {
#define FSS_BLOCKS(CO) dw_blocks<CO>(batch, ci, hq, wq, hs, ws)
  switch (co) {
    case 1: return FSS_BLOCKS(1);
    case 2: return FSS_BLOCKS(2);
    case 3: return FSS_BLOCKS(3);
    case 4: return FSS_BLOCKS(4);
    case 5: return FSS_BLOCKS(5);
    case 6: return FSS_BLOCKS(6);
    case 7: return FSS_BLOCKS(7);
    case 8: return FSS_BLOCKS(8);
    case 9: return FSS_BLOCKS(9);
    case 10: return FSS_BLOCKS(10);
    default: return -1;
  }
#undef FSS_BLOCKS
}

// pivot_fwd's launch on the current device into out[4]: positions a thread,
// support rows a tile, threads a CTA, CTAs. Returns the cudaError_t.
int fss_pivot_fwd_plan(int batch, int ci, int co, int hq, int wq, int hs, int ws, int* out) {
#define FSS_PLAN(CO) fwd_plan<CO>(batch, ci, hq, wq, hs, ws, out)
  FSS_CO_SWITCH(co, FSS_PLAN)
#undef FSS_PLAN
}

// y (B, co, Q, S) from x (B, ci, Q, S), w (ci, 18, co), bias (co).
int fss_pivot_fwd(const float* x, const float* w, const float* bias, float* y, int batch,
                  int ci, int co, int hq, int wq, int hs, int ws, int relu, void* stream) {
#define FSS_FWD(CO) \
  launch_fwd<CO>(x, w, bias, y, batch, ci, hq, wq, hs, ws, relu, (cudaStream_t)stream)
  FSS_CO_SWITCH(co, FSS_FWD)
#undef FSS_FWD
}

// out (18*ci*co + co): dW as (tap, ci, co) with taps 0-8 query, 9-17 support,
// then db; from x (B, ci, Q, S) and g (B, co, Q, S), on the grid of
// fss_pivot_dw_blocks.
int fss_pivot_dw(const float* x, const float* g, float* partial, float* out, int batch,
                 int ci, int co, int hq, int wq, int hs, int ws, int blocks, void* stream) {
#define FSS_DW(CO) \
  launch_dw<CO>(x, g, partial, out, batch, ci, hq, wq, hs, ws, blocks, (cudaStream_t)stream)
  FSS_CO_SWITCH(co, FSS_DW)
#undef FSS_DW
}

#ifdef FSS_PHASE_CLOCKS
// pivot_fwd's cycles per phase, summed over the CTAs of the launches since
// the last call, into out[4]; zeroes them. Returns the cudaError_t.
int fss_pivot_fwd_phase_cycles(unsigned long long* out) {
  static unsigned long long rows[kFwdMaxCtas][kFwdPhases];
  cudaError_t err = cudaMemcpyFromSymbol(rows, fss_fwd_phase_cycles_dev, sizeof(rows));
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < kFwdPhases; ++i) {
    out[i] = 0;
    for (int c = 0; c < kFwdMaxCtas; ++c) out[i] += rows[c][i];
  }
  for (int c = 0; c < kFwdMaxCtas; ++c)
    for (int i = 0; i < kFwdPhases; ++i) rows[c][i] = 0;
  return (int)cudaMemcpyToSymbol(fss_fwd_phase_cycles_dev, rows, sizeof(rows));
}

// pivot_dw's cycles per phase, summed over the CTAs of the launches since
// the last call, into out[5]; zeroes them. Returns the cudaError_t.
int fss_pivot_dw_phase_cycles(unsigned long long* out) {
  static unsigned long long rows[kDwMaxCtas][kDwPhases];
  cudaError_t err = cudaMemcpyFromSymbol(rows, fss_dw_phase_cycles_dev, sizeof(rows));
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < kDwPhases; ++i) {
    out[i] = 0;
    for (int c = 0; c < kDwMaxCtas; ++c) out[i] += rows[c][i];
  }
  for (int c = 0; c < kDwMaxCtas; ++c)
    for (int i = 0; i < kDwPhases; ++i) rows[c][i] = 0;
  return (int)cudaMemcpyToSymbol(fss_dw_phase_cycles_dev, rows, sizeof(rows));
}
#endif

const char* fss_pivot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
