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
// pivot_fwd, per batch b:
//
//   y[co,q,s] = bias[co] + sum_ci sum_{3x3 d} wa[d,ci,co] x[ci, q+d, s]
//                        + sum_ci sum_{3x3 d} wb[d,ci,co] x[ci, q, s+d]
//
// with zero padding at the hq/wq (query plane) and hs/ws (support plane)
// edges, then an optional ReLU. The weights arrive flattened as
// w[ci][tap][co], taps 0-8 the query-plane 3x3 (row-major), 9-17 the
// support-plane 3x3. One thread per (q, s): a block is one query position q
// and FWD_THREADS consecutive support positions, so the query-plane taps
// (same s, neighbouring q rows) are coalesced global reads that neighbouring
// blocks share through L2, and the support-plane taps come from a strip of
// x[ci, q, s0-ws-1 : s0+FWD_THREADS+ws+1] staged in shared memory. Each
// thread holds all CO accumulators in registers; the weights (at most
// 18*10*10 floats) sit in shared memory and are read as broadcasts.
//
// pivot_dw: dW = G . im2col^T summed over every (b, q, s), a product with a
// 13 M-long contraction at 473 px and at most 18*Ci*Co + Co = 1810 outputs:
//
//   dwa[d,ci,co] = sum x[ci, q+d, s] g[co,q,s],  dwb likewise over support
//   shifts, db[co] = sum g[co,q,s].
//
// Blocks run in no order, so the TPU kernels' output block that stays
// resident and accumulates across the sequential grid has no counterpart.
// Pass 1 (pivot_dw_partial_kernel): a fixed grid of blocks walks tiles of
// DW_TILE support positions of one q; each tile's im2col (18*Ci rows) and
// cotangent (CO rows) are built in shared memory; thread k owns im2col row k
// and all CO outputs of that row (threads 18*Ci.. own db), sums the tile
// into a register tile sum and adds that to its running sum, so no fp32
// chain runs longer than DW_TILE + tiles-per-block terms. Each block writes
// its partial sums to a scratch the wrapper allocates. Pass 2
// (pivot_dw_reduce_kernel) sums the partials of every output in block
// order, in double. No atomics: the result is the same from run to run.
//
// Bound (H100 SXM, 67 TFLOP/s fp32, 3.35 TB/s), at 473 px, Q*S = 12.96 M:
// each pivot needs 2*18*Ci*Co*Q*S FLOP and (Ci + Co)*Q*S*4 bytes (every
// element read or written once): 2->10 is 9.33 GFLOP / 0.622 GB, 0.186 ms
// (bytes); 10->10 is 46.66 GFLOP / 1.037 GB, 0.696 ms (operations); 10->1
// is 4.67 GFLOP / 0.570 GB, 0.170 ms (bytes). pivot_dw has the same counts.
// This first design runs the FMAs on the CUDA cores with a broadcast
// shared-memory weight read per FMA (forward) or a shared-memory operand
// load per 4 FMAs (dW), so it is issue-bound well above the bound; the
// tensor-core form (18*Ci taps as the contraction, support positions as N,
// 3xTF32 for fp32 accuracy) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int FWD_THREADS = 256;   // support positions per forward block
constexpr int DW_TILE = 128;       // support positions per dW tile
constexpr int DW_LDA = DW_TILE + 4;  // im2col row stride: float4-aligned, spreads banks
constexpr int DW_MAX_BLOCKS = 1056;  // pass-1 grid: 8 blocks per SM on 132 SMs
constexpr int MAX_CO = 10;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

static_assert(DW_TILE % 4 == 0, "dW tiles are read as float4");

template <int CO>
__global__ void __launch_bounds__(FWD_THREADS)
pivot_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int ci_n, int hq, int wq, int hs, int ws, int relu) {
  extern __shared__ float smem[];
  const int S = hs * ws;
  const int halo = ws + 1;
  const int strip = FWD_THREADS + 2 * halo;
  const size_t plane = (size_t)hq * wq * S;
  float* w_s = smem;                    // ci_n * 18 * CO
  float* x_s = smem + ci_n * 18 * CO;   // ci_n * strip

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * FWD_THREADS;
  const int q = blockIdx.y;
  const float* xb = x + (size_t)blockIdx.z * ci_n * plane;

  for (int i = tid; i < ci_n * 18 * CO; i += FWD_THREADS) w_s[i] = w[i];
  for (int i = tid; i < ci_n * strip; i += FWD_THREADS) {
    const int c = i / strip;
    const int s = s0 - halo + (i - c * strip);
    x_s[i] = (s >= 0 && s < S) ? xb[c * plane + (size_t)q * S + s] : 0.f;
  }
  __syncthreads();

  const int s = s0 + tid;
  if (s >= S) return;  // after the block's only barrier
  const int qi = q / wq, qj = q - qi * wq;
  const int u = s / ws, v = s - u * ws;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = bias[co];

  for (int c = 0; c < ci_n; ++c) {
    const float* xc = xb + c * plane;
    const float* wc = w_s + c * 18 * CO;
#pragma unroll
    for (int t = 0; t < 9; ++t) {       // query plane: rows q +- (1, wq)
      const int ii = qi + t / 3 - 1, jj = qj + t % 3 - 1;
      if (ii < 0 || ii >= hq || jj < 0 || jj >= wq) continue;  // whole block
      const float val = __ldg(xc + (size_t)(ii * wq + jj) * S + s);
#pragma unroll
      for (int co = 0; co < CO; ++co) acc[co] = fmaf(wc[t * CO + co], val, acc[co]);
    }
    const float* xs = x_s + c * strip + halo + tid;
#pragma unroll
    for (int t = 0; t < 9; ++t) {       // support plane: the staged strip
      const int du = t / 3 - 1, dv = t % 3 - 1;
      if (u + du < 0 || u + du >= hs || v + dv < 0 || v + dv >= ws) continue;
      const float val = xs[du * ws + dv];
#pragma unroll
      for (int co = 0; co < CO; ++co)
        acc[co] = fmaf(wc[(9 + t) * CO + co], val, acc[co]);
    }
  }

  float* yb = y + (size_t)blockIdx.z * CO * plane + (size_t)q * S + s;
#pragma unroll
  for (int co = 0; co < CO; ++co) yb[co * plane] = relu ? fmaxf(acc[co], 0.f) : acc[co];
}

template <int CO>
__global__ void pivot_dw_partial_kernel(const float* __restrict__ x,
                                        const float* __restrict__ g,
                                        float* __restrict__ partial,
                                        int ci_n, int hq, int wq, int hs, int ws,
                                        int batch) {
  extern __shared__ float smem[];
  const int S = hs * ws, Q = hq * wq;
  const int K = 18 * ci_n;                      // im2col rows: tap * ci_n + ci
  const size_t plane = (size_t)Q * S;
  const int chunks = (S + DW_TILE - 1) / DW_TILE;
  const long long ntiles = (long long)batch * Q * chunks;
  float* a_s = smem;                            // K * DW_LDA
  float* g_s = smem + K * DW_LDA;               // CO * DW_TILE
  const int tid = threadIdx.x;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int chunk = (int)(t % chunks);
    const long long r = t / chunks;
    const int q = (int)(r % Q);
    const int b = (int)(r / Q);
    const int s0 = chunk * DW_TILE;
    const int qi = q / wq, qj = q - qi * wq;
    const float* xb = x + (size_t)b * ci_n * plane;
    const float* gb = g + (size_t)b * CO * plane;

    for (int i = tid; i < K * DW_TILE; i += blockDim.x) {
      const int k = i / DW_TILE, p = i - k * DW_TILE;
      const int tap = k / ci_n, c = k - tap * ci_n;
      const int s = s0 + p;
      float val = 0.f;
      if (s < S) {
        if (tap < 9) {
          const int ii = qi + tap / 3 - 1, jj = qj + tap % 3 - 1;
          if (ii >= 0 && ii < hq && jj >= 0 && jj < wq)
            val = xb[c * plane + (size_t)(ii * wq + jj) * S + s];
        } else {
          const int u = s / ws + (tap - 9) / 3 - 1;
          const int v = s % ws + (tap - 9) % 3 - 1;
          if (u >= 0 && u < hs && v >= 0 && v < ws)
            val = xb[c * plane + (size_t)q * S + u * ws + v];
        }
      }
      a_s[k * DW_LDA + p] = val;
    }
    for (int i = tid; i < CO * DW_TILE; i += blockDim.x) {
      const int co = i / DW_TILE, s = s0 + (i - co * DW_TILE);
      g_s[i] = s < S ? gb[co * plane + (size_t)q * S + s] : 0.f;
    }
    __syncthreads();

    if (tid < K) {
      float tile[CO];
#pragma unroll
      for (int co = 0; co < CO; ++co) tile[co] = 0.f;
      const float4* arow = reinterpret_cast<const float4*>(a_s + tid * DW_LDA);
      for (int p4 = 0; p4 < DW_TILE / 4; ++p4) {
        const float4 a = arow[p4];
#pragma unroll
        for (int co = 0; co < CO; ++co) {
          const float4 gv = reinterpret_cast<const float4*>(g_s + co * DW_TILE)[p4];
          tile[co] = fmaf(a.x, gv.x, tile[co]);
          tile[co] = fmaf(a.y, gv.y, tile[co]);
          tile[co] = fmaf(a.z, gv.z, tile[co]);
          tile[co] = fmaf(a.w, gv.w, tile[co]);
        }
      }
#pragma unroll
      for (int co = 0; co < CO; ++co) acc[co] += tile[co];
    } else if (tid < K + CO) {
      const float* grow = g_s + (tid - K) * DW_TILE;
      float tile = 0.f;
      for (int p = 0; p < DW_TILE; ++p) tile += grow[p];
      acc[0] += tile;
    }
    __syncthreads();  // the next tile overwrites a_s and g_s
  }

  float* pb = partial + (size_t)blockIdx.x * (K * CO + CO);
  if (tid < K) {
#pragma unroll
    for (int co = 0; co < CO; ++co) pb[tid * CO + co] = acc[co];
  } else if (tid < K + CO) {
    pb[K * CO + (tid - K)] = acc[0];
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

size_t fwd_smem_bytes(int ci, int co, int ws) {
  return sizeof(float) * ((size_t)ci * 18 * co + (size_t)ci * (FWD_THREADS + 2 * (ws + 1)));
}

size_t dw_smem_bytes(int ci, int co) {
  return sizeof(float) * ((size_t)18 * ci * DW_LDA + (size_t)co * DW_TILE);
}

int dw_blocks(int batch, int hq, int wq, int hs, int ws) {
  const long long chunks = (hs * ws + DW_TILE - 1) / DW_TILE;
  const long long ntiles = (long long)batch * hq * wq * chunks;
  return (int)(ntiles < DW_MAX_BLOCKS ? ntiles : DW_MAX_BLOCKS);
}

template <int CO>
cudaError_t launch_fwd(const float* x, const float* w, const float* bias, float* y,
                       int batch, int ci, int hq, int wq, int hs, int ws, int relu,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(ci, CO, ws);
  if (smem > DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        pivot_fwd_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((hs * ws + FWD_THREADS - 1) / FWD_THREADS, hq * wq, batch);
  pivot_fwd_kernel<CO><<<grid, FWD_THREADS, smem, stream>>>(x, w, bias, y, ci, hq, wq,
                                                            hs, ws, relu);
  return cudaGetLastError();
}

template <int CO>
cudaError_t launch_dw(const float* x, const float* g, float* partial, float* out,
                      int batch, int ci, int hq, int wq, int hs, int ws,
                      cudaStream_t stream) {
  const size_t smem = dw_smem_bytes(ci, CO);
  if (smem > DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        pivot_dw_partial_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = dw_blocks(batch, hq, wq, hs, ws);
  const int threads = ((18 * ci + CO + 31) / 32) * 32;
  pivot_dw_partial_kernel<CO><<<blocks, threads, smem, stream>>>(x, g, partial, ci, hq,
                                                                 wq, hs, ws, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = 18 * ci * CO + CO;
  pivot_dw_reduce_kernel<<<(n_out + 127) / 128, 128, 0, stream>>>(partial, out, n_out,
                                                                  blocks);
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

// Dynamic shared memory per block, in bytes (the wrapper refuses what a
// Hopper block cannot hold).
size_t fss_pivot_fwd_smem_bytes(int ci, int co, int ws) { return fwd_smem_bytes(ci, co, ws); }
size_t fss_pivot_dw_smem_bytes(int ci, int co) { return dw_smem_bytes(ci, co); }

// Pass-1 blocks of pivot_dw: the scratch holds blocks * (18*ci*co + co) floats.
int fss_pivot_dw_blocks(int batch, int hq, int wq, int hs, int ws) {
  return dw_blocks(batch, hq, wq, hs, ws);
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
// then db; from x (B, ci, Q, S) and g (B, co, Q, S).
int fss_pivot_dw(const float* x, const float* g, float* partial, float* out, int batch,
                 int ci, int co, int hq, int wq, int hs, int ws, void* stream) {
#define FSS_DW(CO) \
  launch_dw<CO>(x, g, partial, out, batch, ci, hq, wq, hs, ws, (cudaStream_t)stream)
  FSS_CO_SWITCH(co, FSS_DW)
#undef FSS_DW
}

const char* fss_pivot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
