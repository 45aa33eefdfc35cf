// Closed-form K=2 episodic inner loop on Hopper (sm_90a), all steps in one launch.
//
// Replaces the TPU kernel `_kernel` / `adapt_binary_pallas` in
// few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py (the Pallas kernel that the
// JAX package dispatches from episodic/inner_loop.py:_adapt_binary).
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
// * One CTA of 512 threads per episode; all E episodes of a batch in one
//   launch (grid = E). The step loop runs inside the kernel. Shots are
//   processed one after another, so any shot >= 1 is taken.
// * Phase 1: d[p] = f[p, :] . u, one warp per pixel over contiguous
//   channels, then a warp reduce.
// * T = d B^T (h x W) goes to a per-episode global scratch buffer that the
//   wrapper allocates (it stays in L1/L2). Nothing H x W-sized is written to
//   global memory: the H-plane is walked in blocks of kRows rows. For each
//   block, D = A_blk T (one thread per column j, kRows accumulators in
//   registers), g from sigmoid(D) and pws into shared memory, then
//   gB = g B (threads over (column group, k2)) and G += A_blk^T gB.
// * Phase 4: acc[c] += sum_p G[p] f[p, c], one thread per channel, so the
//   reads of f are coalesced across the warp.
// * A and B are used in their DENSE form (every one of the h or w taps is
//   multiplied, zeros included), as the plain version does; A and B have
//   only two non-zeros per row, which a later version can exploit.
//
// Bound: the function needs, per 1-shot step at 473 px with 60x60x512
// features, 2*3600*512*2 FLOP for d = f.u and acc += G.f, plus the four
// interpolation products counted by their non-zeros (A and B hold 886 each:
// two taps per row, one where the source sample is exact) and ~5 ops per
// pixel for g: ~10.4 MFLOP, ~2.1 GFLOP per episode over 200 steps. This
// kernel multiplies the zeros too, ~68 MFLOP per step, 80% of it in the two
// dense 473x473x60 products. f (7.4 MB) is read twice per step. With one
// CTA per episode only E of the card's 132 SMs work. Measured with the
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

constexpr int kThreads = 512;                 // threads per CTA (one episode)
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
struct Layout {
  size_t u, acc, d, G, At, gT, part, gB, total_floats;
};

__host__ __device__ inline Layout make_layout(int h, int w, int C, int W) {
  Layout L;
  size_t o = 0;
  L.u = o;    o += round4(C);
  L.acc = o;  o += round4(C);
  L.d = o;    o += round4((size_t)h * w);
  L.G = o;    o += round4((size_t)h * w);
  L.At = o;   o += round4((size_t)h * kRows);
  L.gT = o;   o += round4((size_t)W * kRows);
  L.part = o; o += (size_t)kGroups * kRows * kGroupW;
  L.gB = o;   o += round4((size_t)kRows * w);
  L.total_floats = o;
  return L;
}

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
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(h, w, C, W);
  float* s_u = smem + L.u;
  float* s_acc = smem + L.acc;
  float* s_d = smem + L.d;
  float* s_G = smem + L.G;
  float* s_At = smem + L.At;      // [k][r]: A rows of the block, transposed
  float* s_gT = smem + L.gT;      // [j][r]: g of the block, transposed
  float* s_part = smem + L.part;  // [group][r][k2 % kGroupW]
  float* s_gB = smem + L.gB;      // [r][k2]

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hw = h * w;
  const float* fs_e = fs + (size_t)e * shot * hw * C;
  const float* pws_e = pws + (size_t)e * shot * H * W;
  float* T = T_all + (size_t)e * h * W;
  const float scale = 2.0f * lr;

  for (int c = tid; c < C; c += kThreads) s_acc[c] = 0.0f;
  __syncthreads();
#ifdef FSS_PHASE_CLOCKS
  unsigned long long ph[kPhases] = {};
  long long t_last = clock64();
#endif

  for (int step = 0; step < num_steps; ++step) {
    for (int c = tid; c < C; c += kThreads) s_u[c] = u0[(size_t)e * C + c] - scale * s_acc[c];
    __syncthreads();

    for (int s = 0; s < shot; ++s) {
      const float* f = fs_e + (size_t)s * hw * C;
      const float* pw = pws_e + (size_t)s * H * W;

      // Phase 1: d = f . u, one warp per pixel.
      for (int p = warp; p < hw; p += kWarps) {
        const float* row = f + (size_t)p * C;
        float v = 0.0f;
        for (int c = lane; c < C; c += 32) v = fmaf(row[c], s_u[c], v);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) s_d[p] = v;
      }
      for (int i = tid; i < hw; i += kThreads) s_G[i] = 0.0f;
      __syncthreads();
      PHASE_MARK(0);

      // T = d B^T: T[k][j] = sum_k2 d[k][k2] * Bt[k2][j].
      for (int idx = tid; idx < h * W; idx += kThreads) {
        const int k = idx / W;
        const int j = idx - k * W;
        const float* drow = s_d + (size_t)k * w;
        float v = 0.0f;
        for (int k2 = 0; k2 < w; ++k2) v = fmaf(drow[k2], Bt[(size_t)k2 * W + j], v);
        T[idx] = v;
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
          float dv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) dv[r] = 0.0f;
          for (int k = 0; k < h; ++k) {
            const float t = T[(size_t)k * W + j];
            const float4* a4 = reinterpret_cast<const float4*>(s_At + (size_t)k * kRows);
#pragma unroll
            for (int q = 0; q < kRows / 4; ++q) {
              const float4 a = a4[q];
              dv[4 * q + 0] = fmaf(a.x, t, dv[4 * q + 0]);
              dv[4 * q + 1] = fmaf(a.y, t, dv[4 * q + 1]);
              dv[4 * q + 2] = fmaf(a.z, t, dv[4 * q + 2]);
              dv[4 * q + 3] = fmaf(a.w, t, dv[4 * q + 3]);
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float g = 0.0f;
            if (r < nr) {
              const float pv = pw[(size_t)(i0 + r) * W + j];
              const float sg = 1.0f / (1.0f + expf(-dv[r]));
              g = fabsf(pv) * (sg - 0.5f) + 0.5f * pv;
            }
            dv[r] = g;
          }
          float4* g4 = reinterpret_cast<float4*>(s_gT + (size_t)j * kRows);
#pragma unroll
          for (int q = 0; q < kRows / 4; ++q)
            g4[q] = make_float4(dv[4 * q + 0], dv[4 * q + 1], dv[4 * q + 2], dv[4 * q + 3]);
        }
        __syncthreads();
        PHASE_MARK(3);

        // Phase 2b: gB = g_blk B, columns k2 split over thread groups by j.
        for (int k2base = 0; k2base < w; k2base += kGroupW) {
          const int kk = tid % kGroupW;
          const int grp = tid / kGroupW;
          const int k2 = k2base + kk;
          float gb[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) gb[r] = 0.0f;
          if (k2 < w) {
            for (int j = grp; j < W; j += kGroups) {
              const float bv = B[(size_t)j * w + k2];
              const float4* g4 = reinterpret_cast<const float4*>(s_gT + (size_t)j * kRows);
#pragma unroll
              for (int q = 0; q < kRows / 4; ++q) {
                const float4 g = g4[q];
                gb[4 * q + 0] = fmaf(g.x, bv, gb[4 * q + 0]);
                gb[4 * q + 1] = fmaf(g.y, bv, gb[4 * q + 1]);
                gb[4 * q + 2] = fmaf(g.z, bv, gb[4 * q + 2]);
                gb[4 * q + 3] = fmaf(g.w, bv, gb[4 * q + 3]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) s_part[((size_t)grp * kRows + r) * kGroupW + kk] = gb[r];
          __syncthreads();
          for (int idx = tid; idx < kRows * kGroupW; idx += kThreads) {
            const int r = idx / kGroupW;
            const int c2 = idx - r * kGroupW;
            if (k2base + c2 < w) {
              float v = 0.0f;
              for (int g = 0; g < kGroups; ++g) v += s_part[((size_t)g * kRows + r) * kGroupW + c2];
              s_gB[(size_t)r * w + k2base + c2] = v;
            }
          }
          __syncthreads();
        }
        PHASE_MARK(4);

        // Phase 3: G += A_blk^T gB.
        for (int idx = tid; idx < hw; idx += kThreads) {
          const int k = idx / w;
          const int k2 = idx - k * w;
          float v = s_G[idx];
#pragma unroll
          for (int r = 0; r < kRows; ++r) v = fmaf(s_At[(size_t)k * kRows + r], s_gB[(size_t)r * w + k2], v);
          s_G[idx] = v;
        }
        __syncthreads();
        PHASE_MARK(5);
      }

      // Phase 4: acc[c] += sum_p G[p] f[p, c], one thread per channel.
      for (int c = tid; c < C; c += kThreads) {
        const float* fc = f + c;
        float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
        int p = 0;
        for (; p + 3 < hw; p += 4) {
          v0 = fmaf(s_G[p + 0], fc[(size_t)(p + 0) * C], v0);
          v1 = fmaf(s_G[p + 1], fc[(size_t)(p + 1) * C], v1);
          v2 = fmaf(s_G[p + 2], fc[(size_t)(p + 2) * C], v2);
          v3 = fmaf(s_G[p + 3], fc[(size_t)(p + 3) * C], v3);
        }
        for (; p < hw; ++p) v0 = fmaf(s_G[p], fc[(size_t)p * C], v0);
        s_acc[c] += (v0 + v1) + (v2 + v3);
      }
      __syncthreads();
      PHASE_MARK(6);
    }
  }
#ifdef FSS_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&fss_phase_cycles_dev[i], ph[i]);
#endif

  for (int c = tid; c < C; c += kThreads) acc_out[(size_t)e * C + c] = s_acc[c];
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these sizes, in bytes.
size_t fss_adapt_binary_smem_bytes(int h, int w, int C, int W) {
  return make_layout(h, w, C, W).total_floats * sizeof(float);
}

// Launches the inner loop for E episodes on `stream`; returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
int fss_adapt_binary(const float* fs, const float* pws, const float* u0,
                     const float* A, const float* B, const float* Bt,
                     float* T_scratch, float* acc, int E, int shot, int h,
                     int w, int C, int H, int W, int num_steps, float lr,
                     void* stream) {
  const size_t smem = fss_adapt_binary_smem_bytes(h, w, C, W);
  cudaError_t err = cudaFuncSetAttribute(
      adapt_binary_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  adapt_binary_kernel<<<E, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fs, pws, u0, A, B, Bt, T_scratch, acc, shot, h, w, C, H, W, num_steps, lr);
  return (int)cudaGetLastError();
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
