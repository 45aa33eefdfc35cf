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
// pivot_dw (pivot_dw.cuh): the weight and bias gradients of the pair, summed
// over every (b, q, s), at most 18*Ci*Co + Co = 1810 outputs from a 13 M-long
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
// tensor cores and the kernel must stream x and g about once. With N = Co
// padded to 8 or 16, every A value loaded from shared memory feeds only
// NT = 1 or 2 MMAs: the fragment loads and their TF32 split, not the tensor
// cores, set a step's least time.
//
// The design: stage rows, not an im2col, and overlap staging with the MMAs.
//  - Work: a step is (b, query row qi, a tile of R whole support rows, query
//    column qj), K = R*ws positions. A unit is a query row's walk along qj
//    at one tile; a persistent grid (one CTA an SM) deals units out
//    round-robin, qi fastest, so CTAs running together stage neighbouring
//    query rows of one tile (a column one stages is in L2 when the others
//    need it), and splits the rest evenly step by step.
//  - Query taps: the 3x3 window of query positions (qi-1..qi+1, qj-1..qj+1)
//    x Ci x tile sits in shared memory, in a ring of nc (4-6) column slots;
//    a step stages only the new column qj+1 (3 rows x Ci x tile), so x is
//    read about 3 + 2/R times, not 9. A query row or column outside the
//    plane is never staged: its rows of A read a zero region.
//  - Support taps: the centre row of each column is staged with its halo
//    (R+2 rows). Staged rows are contiguous, as in x, so a support tap is a
//    constant offset into that buffer; where it steps off a row's end
//    (dv = -1 at v = 0, dv = +1 at v = ws - 1) it reads the neighbouring
//    row's value, and the MMA warps zero it at the load, by the position's
//    edge flags. Rows outside the support plane are copied from a zero
//    buffer in device memory, so every staged row arrives the same way.
//  - Roles (warp specialisation, 416 threads): warp 12 produces, warps 0-11
//    multiply. Both walk the CTA's steps in the same order, so they agree
//    which ring slot holds which column without telling each other.
//  - Producer: its lanes issue one TMA bulk copy (cp.async.bulk) for each
//    (channel, query row): the run of support rows inside the plane, one
//    more for the rows outside it; ~30 a column at Ci = 10 and one for each
//    of g's Co rows. All complete on the slot's full mbarrier, which lane 0
//    arms with the bytes; before reusing a slot the producer waits on its
//    empty mbarrier. Where ws % 4 != 0 or a pointer is not 16-byte aligned
//    the lanes copy the rows themselves and lane 0 arrives.
//  - MMAs: the MMA warps wait on the full barriers of the step's new
//    column(s) and g tile; each fragment value is split as it is loaded into
//    big = cvt.rna.tf32(a) and small = cvt.rna.tf32(a - big) (a - big is
//    finite wherever a is, so small takes cvt.rna's integer step alone),
//    and mma.sync.m16n8k8 TF32 issues big.big + big.small + small.big
//    (small.small is dropped), which keeps fp32 accuracy. Then they arrive
//    on the empty barriers of the g tile and of the columns the next step
//    does not read. The copies of the steps ahead land under a step's MMAs;
//    nothing waits on the whole CTA.
//  - Depth: R (at most 8) and nc follow from the shape and the 227 KB a
//    block may hold (dw_plan): at 473 px R = 6 at 10->10, 7 at 10->1 (4
//    slots), 8 at Ci = 1 and 2 (6 slots).
//  - Fragment loads: a row of A is a base that changes once a step; its
//    value at position p sits at base + ws + p. Ragged widths (ws = 60 is no
//    multiple of 8): K is padded to a multiple of 8 with g = 0 (the padded
//    positions read a real staged value of x).
//  - A warp owns 4 m-tiles (those past the last are skipped) and every
//    n-tile for a share of the k-chunks; its fragments accumulate over 16
//    support rows of steps, then are added to per-thread running sums. The
//    warps' sums are added in shared memory in a fixed order, each CTA
//    writes one partial row, and pivot_dw_reduce_kernel sums the rows in
//    order, in double. No atomics: every launch gives the same bits.
// Where a step's time goes (tools/profile_pivot.py --phases, PERF.md): the
// -DFSS_PHASE_CLOCKS build counts, a CTA and a step, the MMA warps' wait on
// a full stage, the producer's wait on an empty slot, the producer's
// issue, and the MMAs with their split. The MMA warps wait 4-12% of their
// step: the copies hide under the MMAs, and the MMAs, issue-bound on the
// split and the fragment loads (~240 instructions for 24 MMAs a k-chunk),
// set the pace.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_CO = 10;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

// fp32 -> TF32 (the low 13 bits zero), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// pivot_dw's named barrier 1 over its MMA warps alone (12 x 32 threads).
__device__ __forceinline__ void mma_warps_sync() {
  asm volatile("bar.sync 1, 384;\n" ::: "memory");
}

#define FSS_SHARED(name) extern __shared__ float name[]
#include "pivot_fwd.cuh"

// ---- pivot_dw --------------------------------------------------------------

#ifdef FSS_PHASE_CLOCKS
// Built with -DFSS_PHASE_CLOCKS, one thread of each role reads clock64()
// around its phases and adds the cycles to its CTA's row of counters, read
// by fss_pivot_dw_phase_cycles(): the MMA warps' wait on a full stage, the
// producer's wait on an empty slot, the producer's issue, the MMAs.
constexpr int kDwMaxCtas = 1024;
constexpr int kDwPhases = 4;
__device__ unsigned long long fss_dw_phase_cycles_dev[kDwMaxCtas][kDwPhases];
#define DW_CLOCK() clock64()
#define DW_PHASES_END(ph)                                    \
  if (blockIdx.x < kDwMaxCtas)                               \
    for (int i = 0; i < kDwPhases; ++i)                      \
      if (ph[i]) fss_dw_phase_cycles_dev[blockIdx.x][i] += ph[i]
#else
#define DW_CLOCK() 0LL
#define DW_PHASES_END(ph) \
  do {                    \
  } while (0)
#endif

#include "pivot_dw.cuh"
#ifdef FSS_PHASE_CLOCKS
static_assert(DW_PHASES == kDwPhases, "one counter a phase");
#endif

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
  return sizeof(float) * (size_t)dw_plan(ci, co, ws).floats;
}

template <int CO>
cudaError_t dw_prepare(int ci, int ws, DwLayout* L) {
  *L = dw_plan(ci, CO, ws);
  const size_t smem = sizeof(float) * (size_t)L->floats;
  if (smem > DEFAULT_SMEM)
    return cudaFuncSetAttribute(pivot_dw_mma_kernel<CO>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

// The persistent grid: every CTA the card holds at once, at most one a step.
template <int CO>
int dw_blocks(int batch, int ci, int hq, int wq, int hs, int ws) {
  DwLayout L;
  if (dw_prepare<CO>(ci, ws, &L) != cudaSuccess) return -1;
  int dev, sms, per_sm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pivot_dw_mma_kernel<CO>,
                                                    DW_THREADS,
                                                    sizeof(float) * (size_t)L.floats) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long steps = (long long)batch * hq * ((hs + L.rows - 1) / L.rows) * wq;
  const long long grid = (long long)sms * per_sm;
  return (int)(steps < grid ? steps : grid);
}

template <int CO>
cudaError_t launch_dw(const float* x, const float* g, float* partial, float* out,
                      int batch, int ci, int hq, int wq, int hs, int ws, int blocks,
                      cudaStream_t stream) {
  if (ci < 1 || ci > DW_MAX_CI || blocks < 1) return cudaErrorInvalidValue;
  DwLayout L;
  cudaError_t err = dw_prepare<CO>(ci, ws, &L);
  if (err != cudaSuccess) return err;
  // bulk copies where every staged row starts 16-byte aligned
  const int bulk = ws % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0;
  pivot_dw_mma_kernel<CO><<<blocks, DW_THREADS, sizeof(float) * (size_t)L.floats, stream>>>(
      x, g, partial, ci, hq, wq, hs, ws, batch, L.rows, L.nc, bulk);
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

// pivot_dw's layout for a shape into out[4]: support rows a step, column
// slots, g slots, threads a CTA; returns its shared bytes, as
// fss_pivot_dw_smem_bytes.
size_t fss_pivot_dw_plan(int ci, int co, int ws, int* out) {
  const DwLayout L = dw_plan(ci, co, ws);
  out[0] = L.rows;
  out[1] = L.nc;
  out[2] = L.ng;
  out[3] = DW_THREADS;
  return sizeof(float) * (size_t)L.floats;
}

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

// pivot_dw's cycles per phase (the MMA warps' wait on a full stage, the
// producer's wait on an empty slot, the producer's issue, the MMAs), summed
// over the CTAs of the launches since the last call, into out[4]; zeroes
// them. Returns the cudaError_t.
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
