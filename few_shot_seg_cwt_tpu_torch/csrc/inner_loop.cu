// Closed-form K=2 episodic inner loop on Hopper (sm_90a), all steps in one launch.
//
// Two kernels share one body, `adapt_binary_body<TILE>`:
// * K1 `adapt_binary_kernel` replaces the TPU kernel `_kernel` /
//   `adapt_binary_pallas` in few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py
//   (dispatched from episodic/inner_loop.py:_adapt_binary): one episode per CTA.
// * K2 `adapt_binary_tiled_kernel<TILE>` replaces `_tiled_kernel` /
//   `adapt_binary_pallas_tiled` in the same file (dispatched under the
//   engines' episode vmap when FSS_INNER_TILE > 1): TILE 1-shot episodes per
//   CTA, evolved jointly so that one episode's load latency hides behind the
//   others' work, as the TPU kernel interleaves independent chains. TILE is
//   2, 3 or 4; at 473 px only 2 fits a block's shared memory (170,624 B of
//   232,448; 4 would need 304,640).
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
// forms the adapted rows W0 + lr*acc and W1 - lr*acc.
//
// Design (the simple one; see "Bound" below for what limits it):
// * One CTA of 512 threads per TILE episodes (grid = E / TILE). The step
//   loop runs inside the kernel. Shots are processed one after another, so
//   any shot >= 1 is taken (the wrapper gives K2 1-shot episodes only, as
//   the TPU kernel takes).
// * Phase 1: d[p] = f[p, :] . u, one warp per pixel over contiguous
//   channels, then a warp reduce.
// * T = d B^T (h x W) goes to a per-episode global scratch buffer that the
//   wrapper allocates (it stays in L1/L2). Nothing H x W-sized is written to
//   global memory: the H-plane is walked in blocks of kRows rows. For each
//   block, D = A_blk T (one thread per column j, kRows accumulators per
//   episode in registers), g from sigmoid(D) and pws into shared memory,
//   then gB = g B (threads over (column group, k2)) and G += A_blk^T gB.
// * Phase 4: acc[c] += sum_p G[p] f[p, c], one thread per channel, so the
//   reads of f are coalesced across the warp.
// * A and B are used in their DENSE form (every one of the h or w taps is
//   multiplied, zeros included), as the plain version does; A and B have
//   only two non-zeros per row, which a later version can exploit.
// * Per episode, shared memory holds u, acc, d, G, the block's g and gB;
//   the block's A rows and the gB partial sums are shared by the tile.
//
// Bound: the function needs, per 1-shot step at 473 px with 60x60x512
// features, 2*3600*512*2 FLOP for d = f.u and acc += G.f, plus the four
// interpolation products counted by their non-zeros (A and B hold 886 each:
// two taps per row, one where the source sample is exact) and ~5 ops per
// pixel for g: ~10.4 MFLOP, ~2.1 GFLOP per episode over 200 steps. This
// kernel multiplies the zeros too, ~68 MFLOP per step, 80% of it in the two
// dense 473x473x60 products. f (7.4 MB) is read twice per step. With one
// CTA per episode only E of the card's 132 SMs work (E / TILE for K2). Measured with the
// phase clocks below (tools/profile_inner_loop.py, numbers in PERF.md), the
// kernel waits on memory latency, not fp32 throughput: D = A T stalls on its
// global read of T in every iteration of its k loop, and acc += G.f streams
// f with only the few loads 16 warps keep in flight. The fixes (later
// work): split an episode over a thread-block cluster or a cooperative
// grid, keep T in shared memory, batch the loads of f, and use the two-tap
// structure of A and B.
//
// Built with -DFSS_PHASE_CLOCKS, thread 0 of each CTA reads clock64() after
// every block-wide barrier and adds the cycles of each phase to a device
// counter, read by fss_phase_cycles(); the default build has none of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;                 // threads per CTA
constexpr int kRows = 16;                     // H-plane rows per block
constexpr int kGroupW = 64;                   // columns of gB per thread group
constexpr int kGroups = kThreads / kGroupW;   // thread groups splitting W
constexpr int kWarps = kThreads / 32;

static_assert(kRows % 4 == 0, "kRows is read as float4");

#ifdef FSS_PHASE_CLOCKS
// u + d, T, A-slice load, D + g, gB, G, acc
constexpr int kPhases = 7;
__device__ unsigned long long fss_phase_cycles_dev[kPhases];
#define PHASE_MARK(i)                          \
  do {                                         \
    if (tid == 0) {                            \
      const long long now = clock64();         \
      ph[i] += (unsigned long long)(now - t_last); \
      t_last = now;                            \
    }                                          \
  } while (0)
#else
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#endif

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// Shared-memory layout in floats; every segment starts 16-byte aligned.
// u .. gB belong to one episode and repeat `tile` times, `ep` floats apart;
// At and part are shared by the tile's episodes.
struct Layout {
  size_t u, acc, d, G, gT, gB, ep, At, part, total_floats;
};

__host__ __device__ inline Layout make_layout(int h, int w, int C, int W, int tile) {
  Layout L;
  size_t o = 0;
  L.u = o;    o += round4(C);
  L.acc = o;  o += round4(C);
  L.d = o;    o += round4((size_t)h * w);
  L.G = o;    o += round4((size_t)h * w);
  L.gT = o;   o += round4((size_t)W * kRows);
  L.gB = o;   o += round4((size_t)kRows * w);
  L.ep = o;
  o *= tile;
  L.At = o;   o += round4((size_t)h * kRows);
  L.part = o; o += (size_t)kGroups * kRows * kGroupW;
  L.total_floats = o;
  return L;
}

// The inner loop of TILE episodes in one CTA (episodes blockIdx.x * TILE
// .. + TILE - 1). Each phase loops over the tile's episodes inside one
// barrier interval, so a thread has TILE independent chains in flight: in
// D = A T it reads T of every episode against one shared-memory read of A,
// in gB = g B one read of B serves every episode, and in acc += G f it
// streams f of every episode. Per episode the arithmetic and its order are
// K1's, so TILE > 1 gives K1's accumulators.
template <int TILE>
__device__ __forceinline__ void adapt_binary_body(
    const float* __restrict__ fs, const float* __restrict__ pws,
    const float* __restrict__ u0, const float* __restrict__ A,
    const float* __restrict__ B, const float* __restrict__ Bt, float* T_all,
    float* __restrict__ acc_out, int shot, int h, int w, int C, int H, int W,
    int num_steps, float lr) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(h, w, C, W, TILE);
  float* s_At = smem + L.At;      // [k][r]: A rows of the block, transposed
  float* s_part = smem + L.part;  // [group][r][k2 % kGroupW]
  // per episode t: u, acc, d, G, gT ([j][r]: g of the block, transposed), gB ([r][k2])
#define EP(seg, t) (smem + L.seg + (size_t)(t) * L.ep)

  const int e0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hw = h * w;
  const float scale = 2.0f * lr;

#pragma unroll
  for (int t = 0; t < TILE; ++t)
    for (int c = tid; c < C; c += kThreads) EP(acc, t)[c] = 0.0f;
  __syncthreads();
#ifdef FSS_PHASE_CLOCKS
  unsigned long long ph[kPhases] = {};
  long long t_last = clock64();
#endif

  for (int step = 0; step < num_steps; ++step) {
#pragma unroll
    for (int t = 0; t < TILE; ++t)
      for (int c = tid; c < C; c += kThreads)
        EP(u, t)[c] = u0[(size_t)(e0 + t) * C + c] - scale * EP(acc, t)[c];
    __syncthreads();

    for (int s = 0; s < shot; ++s) {
      const float* f[TILE];
      const float* pw[TILE];
      float* T[TILE];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        f[t] = fs + ((size_t)(e0 + t) * shot + s) * hw * C;
        pw[t] = pws + ((size_t)(e0 + t) * shot + s) * H * W;
        T[t] = T_all + (size_t)(e0 + t) * h * W;
      }

      // Phase 1: d = f . u, one warp per pixel.
      for (int p = warp; p < hw; p += kWarps) {
        float v[TILE];
#pragma unroll
        for (int t = 0; t < TILE; ++t) v[t] = 0.0f;
        for (int c = lane; c < C; c += 32) {
#pragma unroll
          for (int t = 0; t < TILE; ++t) v[t] = fmaf(f[t][(size_t)p * C + c], EP(u, t)[c], v[t]);
        }
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v[t] += __shfl_xor_sync(0xffffffffu, v[t], o);
          if (lane == 0) EP(d, t)[p] = v[t];
        }
      }
#pragma unroll
      for (int t = 0; t < TILE; ++t)
        for (int i = tid; i < hw; i += kThreads) EP(G, t)[i] = 0.0f;
      __syncthreads();
      PHASE_MARK(0);

      // T = d B^T: T[k][j] = sum_k2 d[k][k2] * Bt[k2][j].
      for (int idx = tid; idx < h * W; idx += kThreads) {
        const int k = idx / W;
        const int j = idx - k * W;
        float v[TILE];
#pragma unroll
        for (int t = 0; t < TILE; ++t) v[t] = 0.0f;
        for (int k2 = 0; k2 < w; ++k2) {
          const float bt = Bt[(size_t)k2 * W + j];
#pragma unroll
          for (int t = 0; t < TILE; ++t) v[t] = fmaf(EP(d, t)[(size_t)k * w + k2], bt, v[t]);
        }
#pragma unroll
        for (int t = 0; t < TILE; ++t) T[t][idx] = v[t];
      }
      __syncthreads();
      PHASE_MARK(1);

      for (int i0 = 0; i0 < H; i0 += kRows) {
        const int nr = min(kRows, H - i0);
        for (int idx = tid; idx < h * kRows; idx += kThreads) {
          const int k = idx / kRows;
          const int r = idx - k * kRows;
          s_At[idx] = (r < nr) ? A[(size_t)(i0 + r) * h + k] : 0.0f;
        }
        __syncthreads();
        PHASE_MARK(2);

        // Phase 2a: D = A_blk T, then g, for kRows rows at once.
        for (int j = tid; j < W; j += kThreads) {
          float dv[TILE][kRows];
#pragma unroll
          for (int t = 0; t < TILE; ++t)
#pragma unroll
            for (int r = 0; r < kRows; ++r) dv[t][r] = 0.0f;
          for (int k = 0; k < h; ++k) {
            float tv[TILE];
#pragma unroll
            for (int t = 0; t < TILE; ++t) tv[t] = T[t][(size_t)k * W + j];
            const float4* a4 = reinterpret_cast<const float4*>(s_At + (size_t)k * kRows);
#pragma unroll
            for (int q = 0; q < kRows / 4; ++q) {
              const float4 a = a4[q];
#pragma unroll
              for (int t = 0; t < TILE; ++t) {
                dv[t][4 * q + 0] = fmaf(a.x, tv[t], dv[t][4 * q + 0]);
                dv[t][4 * q + 1] = fmaf(a.y, tv[t], dv[t][4 * q + 1]);
                dv[t][4 * q + 2] = fmaf(a.z, tv[t], dv[t][4 * q + 2]);
                dv[t][4 * q + 3] = fmaf(a.w, tv[t], dv[t][4 * q + 3]);
              }
            }
          }
#pragma unroll
          for (int t = 0; t < TILE; ++t) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float g = 0.0f;
              if (r < nr) {
                const float pv = pw[t][(size_t)(i0 + r) * W + j];
                const float sg = 1.0f / (1.0f + expf(-dv[t][r]));
                g = fabsf(pv) * (sg - 0.5f) + 0.5f * pv;
              }
              dv[t][r] = g;
            }
            float4* g4 = reinterpret_cast<float4*>(EP(gT, t) + (size_t)j * kRows);
#pragma unroll
            for (int q = 0; q < kRows / 4; ++q)
              g4[q] = make_float4(dv[t][4 * q + 0], dv[t][4 * q + 1], dv[t][4 * q + 2],
                                  dv[t][4 * q + 3]);
          }
        }
        __syncthreads();
        PHASE_MARK(3);

        // Phase 2b: gB = g_blk B, columns k2 split over thread groups by j;
        // the groups' partial sums are reduced one episode at a time.
        for (int k2base = 0; k2base < w; k2base += kGroupW) {
          const int kk = tid % kGroupW;
          const int grp = tid / kGroupW;
          const int k2 = k2base + kk;
          float gb[TILE][kRows];
#pragma unroll
          for (int t = 0; t < TILE; ++t)
#pragma unroll
            for (int r = 0; r < kRows; ++r) gb[t][r] = 0.0f;
          if (k2 < w) {
            for (int j = grp; j < W; j += kGroups) {
              const float bv = B[(size_t)j * w + k2];
#pragma unroll
              for (int t = 0; t < TILE; ++t) {
                const float4* g4 = reinterpret_cast<const float4*>(EP(gT, t) + (size_t)j * kRows);
#pragma unroll
                for (int q = 0; q < kRows / 4; ++q) {
                  const float4 g = g4[q];
                  gb[t][4 * q + 0] = fmaf(g.x, bv, gb[t][4 * q + 0]);
                  gb[t][4 * q + 1] = fmaf(g.y, bv, gb[t][4 * q + 1]);
                  gb[t][4 * q + 2] = fmaf(g.z, bv, gb[t][4 * q + 2]);
                  gb[t][4 * q + 3] = fmaf(g.w, bv, gb[t][4 * q + 3]);
                }
              }
            }
          }
#pragma unroll
          for (int t = 0; t < TILE; ++t) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              s_part[((size_t)grp * kRows + r) * kGroupW + kk] = gb[t][r];
            __syncthreads();
            for (int idx = tid; idx < kRows * kGroupW; idx += kThreads) {
              const int r = idx / kGroupW;
              const int c2 = idx - r * kGroupW;
              if (k2base + c2 < w) {
                float v = 0.0f;
                for (int g = 0; g < kGroups; ++g) v += s_part[((size_t)g * kRows + r) * kGroupW + c2];
                EP(gB, t)[(size_t)r * w + k2base + c2] = v;
              }
            }
            __syncthreads();
          }
        }
        PHASE_MARK(4);

        // Phase 3: G += A_blk^T gB.
        for (int idx = tid; idx < hw; idx += kThreads) {
          const int k = idx / w;
          const int k2 = idx - k * w;
#pragma unroll
          for (int t = 0; t < TILE; ++t) {
            const float* gBt = EP(gB, t);
            float v = EP(G, t)[idx];
#pragma unroll
            for (int r = 0; r < kRows; ++r) v = fmaf(s_At[(size_t)k * kRows + r], gBt[(size_t)r * w + k2], v);
            EP(G, t)[idx] = v;
          }
        }
        __syncthreads();
        PHASE_MARK(5);
      }

      // Phase 4: acc[c] += sum_p G[p] f[p, c], one thread per channel.
      for (int c = tid; c < C; c += kThreads) {
        float v0[TILE], v1[TILE], v2[TILE], v3[TILE];
#pragma unroll
        for (int t = 0; t < TILE; ++t) v0[t] = v1[t] = v2[t] = v3[t] = 0.0f;
        int p = 0;
        for (; p + 3 < hw; p += 4) {
#pragma unroll
          for (int t = 0; t < TILE; ++t) {
            const float* fc = f[t] + c;
            const float* Gt = EP(G, t);
            v0[t] = fmaf(Gt[p + 0], fc[(size_t)(p + 0) * C], v0[t]);
            v1[t] = fmaf(Gt[p + 1], fc[(size_t)(p + 1) * C], v1[t]);
            v2[t] = fmaf(Gt[p + 2], fc[(size_t)(p + 2) * C], v2[t]);
            v3[t] = fmaf(Gt[p + 3], fc[(size_t)(p + 3) * C], v3[t]);
          }
        }
        for (; p < hw; ++p) {
#pragma unroll
          for (int t = 0; t < TILE; ++t) v0[t] = fmaf(EP(G, t)[p], f[t][(size_t)p * C + c], v0[t]);
        }
#pragma unroll
        for (int t = 0; t < TILE; ++t) EP(acc, t)[c] += (v0[t] + v1[t]) + (v2[t] + v3[t]);
      }
      __syncthreads();
      PHASE_MARK(6);
    }
  }
#ifdef FSS_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&fss_phase_cycles_dev[i], ph[i]);
#endif

#pragma unroll
  for (int t = 0; t < TILE; ++t)
    for (int c = tid; c < C; c += kThreads) acc_out[(size_t)(e0 + t) * C + c] = EP(acc, t)[c];
#undef EP
}

// K1: one episode per CTA (grid = E).
__global__ void __launch_bounds__(kThreads, 1)
adapt_binary_kernel(const float* __restrict__ fs,    // (E, shot, h*w, C)
                    const float* __restrict__ pws,   // (E, shot, H, W)
                    const float* __restrict__ u0,    // (E, C)
                    const float* __restrict__ A,     // (H, h)
                    const float* __restrict__ B,     // (W, w)
                    const float* __restrict__ Bt,    // (w, W)
                    float* T_all,                    // (E, h, W) scratch
                    float* __restrict__ acc_out,     // (E, C)
                    int shot, int h, int w, int C, int H, int W,
                    int num_steps, float lr) {
  adapt_binary_body<1>(fs, pws, u0, A, B, Bt, T_all, acc_out, shot, h, w, C, H, W,
                       num_steps, lr);
}

// K2: TILE episodes per CTA (grid = E / TILE), same arguments.
template <int TILE>
__global__ void __launch_bounds__(kThreads, 1)
adapt_binary_tiled_kernel(const float* __restrict__ fs, const float* __restrict__ pws,
                          const float* __restrict__ u0, const float* __restrict__ A,
                          const float* __restrict__ B, const float* __restrict__ Bt,
                          float* T_all, float* __restrict__ acc_out, int shot, int h,
                          int w, int C, int H, int W, int num_steps, float lr) {
  adapt_binary_body<TILE>(fs, pws, u0, A, B, Bt, T_all, acc_out, shot, h, w, C, H, W,
                          num_steps, lr);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, int grid, size_t smem, void* stream, const float* fs,
                  const float* pws, const float* u0, const float* A, const float* B,
                  const float* Bt, float* T_scratch, float* acc, int shot, int h, int w,
                  int C, int H, int W, int num_steps, float lr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fs, pws, u0, A, B, Bt, T_scratch, acc, shot, h, w, C, H, W, num_steps, lr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these sizes, in bytes.
size_t fss_adapt_binary_smem_bytes(int h, int w, int C, int W) {
  return make_layout(h, w, C, W, 1).total_floats * sizeof(float);
}

// Dynamic shared memory of the tiled kernel (K2) at `tile` episodes per CTA.
size_t fss_adapt_binary_tiled_smem_bytes(int h, int w, int C, int W, int tile) {
  return make_layout(h, w, C, W, tile).total_floats * sizeof(float);
}

// Launches the inner loop for E episodes on `stream`; returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
int fss_adapt_binary(const float* fs, const float* pws, const float* u0,
                     const float* A, const float* B, const float* Bt,
                     float* T_scratch, float* acc, int E, int shot, int h,
                     int w, int C, int H, int W, int num_steps, float lr,
                     void* stream) {
  return launch_kernel(adapt_binary_kernel, E, fss_adapt_binary_smem_bytes(h, w, C, W),
                       stream, fs, pws, u0, A, B, Bt, T_scratch, acc, shot, h, w, C, H,
                       W, num_steps, lr);
}

// The same for `tile` episodes per CTA (tile 2, 3 or 4; E % tile == 0);
// cudaErrorInvalidValue for another tile.
int fss_adapt_binary_tiled(const float* fs, const float* pws, const float* u0,
                           const float* A, const float* B, const float* Bt,
                           float* T_scratch, float* acc, int E, int shot, int h,
                           int w, int C, int H, int W, int num_steps, float lr,
                           int tile, void* stream) {
  if (tile < 2 || tile > 4 || E % tile != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fss_adapt_binary_tiled_smem_bytes(h, w, C, W, tile);
  const int grid = E / tile;
  switch (tile) {
    case 2:
      return launch_kernel(adapt_binary_tiled_kernel<2>, grid, smem, stream, fs, pws, u0,
                           A, B, Bt, T_scratch, acc, shot, h, w, C, H, W, num_steps, lr);
    case 3:
      return launch_kernel(adapt_binary_tiled_kernel<3>, grid, smem, stream, fs, pws, u0,
                           A, B, Bt, T_scratch, acc, shot, h, w, C, H, W, num_steps, lr);
    default:
      return launch_kernel(adapt_binary_tiled_kernel<4>, grid, smem, stream, fs, pws, u0,
                           A, B, Bt, T_scratch, acc, shot, h, w, C, H, W, num_steps, lr);
  }
}

#ifdef FSS_PHASE_CLOCKS
// Copies the per-phase cycle sums over all CTAs of the launches since the
// last call into out[7] and zeroes them; returns the cudaError_t.
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
