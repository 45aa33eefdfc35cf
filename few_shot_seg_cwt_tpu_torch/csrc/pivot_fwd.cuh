// pivot_fwd: the forward of the centre-pivot pair on Hopper's CUDA cores, fp32.
//
// Replaces `_mxu_fwd_kernel` (few_shot_seg_cwt_tpu/ops/pallas_pivot_mxu.py,
// MXU form) and `_pivot_fwd_kernel` (ops/pallas_pivot.py, VPU form). Per
// batch element b, on channels-major (B, C, Q, S) volumes:
//
//   y[co,q,s] = bias[co] + sum_ci sum_{3x3 d} wa[d,ci,co] x[ci, q+d, s]
//                        + sum_ci sum_{3x3 d} wb[d,ci,co] x[ci, q, s+d]
//
// with zero padding at the query-plane (hq, wq) and support-plane (hs, ws)
// edges, then an optional ReLU. It also computes dx in the backward (Ci and
// Co swapped, flipped weights). The weights arrive as w[ci][tap][co], taps
// 0-8 the query-plane 3x3 and 9-17 the support-plane 3x3, row-major.
//
// What bounds it at 473 px (60x60 planes, Q = S = 3600; H100 SXM: 3.35 TB/s,
// 67 TFLOP/s fp32 on the CUDA cores; bytes (Ci + Co) Q S 4, FMAs 18 Ci Co Q S):
//   2->10 and 10->2:  0.622 GB, 0.186 ms of bytes; 9.33 GFLOP, 0.139 ms fp32
//   10->10:           1.037 GB, 0.310 ms;         46.66 GFLOP, 0.696 ms fp32
//   10->1 and 1->10:  0.570 GB, 0.170 ms;          4.67 GFLOP, 0.070 ms fp32
// So 10->10 is the one shape bound by operations on the CUDA cores: 0.696 ms,
// against the 0.309 ms of bytes that the repo's bound table gives it (the
// table lets the operations run as 3xTF32 on the tensor cores, 0.283 ms).
// The others are bound by bytes: each x value should come from device
// memory about once, and y be written once.
//
// The design (the previous forward kernel read x about ten times through
// L1/L2, nine query taps straight from global memory, and did one shared
// load per FMA):
//  - Work: a step is (b, support tile of `rows` whole support rows, query row
//    qi, query column qj); the CTA computes y at q = (qi, qj) for the tile's
//    rows * ws support positions. Steps are numbered with qj fastest, then
//    qi, then the tile, then b; a row of steps (one qj walk) is a unit.
//  - Persistent grid (SM count x CTAs an SM, from the occupancy query, no
//    grid-dimension cap): units are dealt out round-robin, so CTAs that run
//    at the same time walk neighbouring query rows of the same support tile,
//    and a column staged by one is still in L2 when the CTAs on rows qi-1
//    and qi+1 stage it. The units left after the full rounds are split
//    evenly, step by step, over all CTAs.
//  - Query window staged once: a ring of FWD_SLOTS query columns in shared
//    memory, each 3 query rows (qi-1, qi, qi+1) x ci x the tile's support
//    rows. A step stages only the new column qj+2 for the next step, while
//    this step computes. So each x value is read from L2 about 3 times (as
//    rows qi-1, qi, qi+1), never 9.
//  - Staging by TMA: the tile's support rows of one (channel, query row)
//    are contiguous in x, so each is one bulk copy (cp.async.bulk, ~30 a
//    column at Ci = 10) that completes on the slot's mbarrier; thread 0
//    arms it with the column's bytes. The first version issued 16-byte
//    cp.async per lane (~3,000 a column): issuing them took 9.5-16.6 K
//    cycles of a 21-25 K-cycle step at Ci = 10 (tools/profile_pivot.py
//    --fwd --phases), the issue rate growing with the CTA's warps. Where ws
//    % 4 != 0 or a pointer is not 16-byte aligned, the threads copy rows
//    themselves.
//  - Rows are staged without gaps (stride ws rounded up to 4); the centre
//    row qi carries a one-row support halo, and the taps dv = -1 and +1 at
//    a row's ends take 0 by a select, so a support tap needs no edge test
//    in memory. Support rows outside the plane are stored as zeros; a query
//    row or column outside the plane is never staged: its taps read a zero
//    region (channel stride 0).
//  - Outputs blocked in registers: a thread owns P consecutive support
//    positions of one row (P = 2 for Co > 4, else 4) and all CO accumulators.
//    Weights sit in shared memory as w[ci][tap][co], co padded to 4, read as
//    float4 broadcasts, each feeding P FMAs; the P + 2 x values of a support
//    row feed its three taps dv = -1, 0, +1.
//  - The per-output chain is the previous kernel's: acc = bias, then for each ci
//    the 9 query taps and then the 9 support taps, with fmaf. A tap outside
//    the plane adds w * 0, so the values equal that kernel's up to the sign
//    of zero, and every launch gives the same bits (no atomics).
//  - y is written once, with the ReLU at the store (float2/float4 stores
//    where ws % 4 == 0 and y is 16-byte aligned).
//
// This header is included by pivot.cu (inside its namespace) and by
// pivot_fwd_emulated.cpp, which runs the same kernel on the CPU through
// cuda_emulation.h. Device intrinsics come from the includer: bulk_copy_g2s,
// mbar_init, mbar_expect_tx, mbar_wait, fence_mbar_init, fence_proxy_async,
// __syncthreads, FSS_SHARED, and FWD_PHASE(i) (pivot.cu's -DFSS_PHASE_CLOCKS
// build adds thread 0's cycles since the last mark to phase i).

constexpr int FWD_THREADS = 256;       // most threads a forward CTA runs
constexpr int FWD_SLOTS = 4;           // columns staged: the window's 3 and the next
constexpr int FWD_MAX_SMEM = 232448;   // shared memory one Hopper block may use

// Support positions a thread owns (consecutive along a support row).
__host__ __device__ constexpr int fwd_p(int co) { return co > 4 ? 2 : 4; }

// Shared-memory layout of pivot_fwd_kernel, in floats (the same on the host
// and the device). Offsets are multiples of 4 (16-byte copies and loads).
struct FwdLayout {
  int p, tpr;     // positions a thread; threads' groups a support row
  int rows;       // support rows a tile
  int threads;    // the CTA's threads (a multiple of 32, at most FWD_THREADS)
  int ld;         // staged row stride: ws rounded up to 4, the tail zero
  int csq, csc;   // channel strides: rows qi -+ 1 (rows rows), the centre
                  // row qi (rows + 2, with the support halo)
  int slot;       // one staged query column: ci * (2 csq + csc)
  int cop;        // co padded to 4
  int w;          // the weights w[ci][tap][cop], after the slots' barriers
  int zr;         // the zero region, rows * ld floats
  int xs;         // the ring of FWD_SLOTS columns
  int floats;     // all of it, and 4 floats that a row's last tap may read
};

__host__ __device__ inline FwdLayout fwd_layout(int ci, int co, int ws, int rows) {
  FwdLayout l;
  l.p = fwd_p(co);
  l.tpr = (ws + l.p - 1) / l.p;
  l.rows = rows;
  const int groups = rows * l.tpr;
  l.threads = groups < FWD_THREADS ? (groups + 31) / 32 * 32 : FWD_THREADS;
  l.ld = (ws + 3) / 4 * 4;
  l.csq = rows * l.ld;
  l.csc = (rows + 2) * l.ld;
  l.slot = ci * (2 * l.csq + l.csc);
  l.cop = (co + 3) / 4 * 4;
  l.w = 2 * FWD_SLOTS;  // FWD_SLOTS 8-byte mbarriers
  l.zr = l.w + ci * 18 * l.cop;
  l.xs = l.zr + rows * l.ld;
  l.floats = l.xs + FWD_SLOTS * l.slot + 4;
  return l;
}

// Support rows a tile: enough for FWD_THREADS threads' groups, at most hs,
// fewer where the layout would not fit a block (1 if even one row does not:
// the caller then refuses the shape).
__host__ __device__ inline int fwd_rows(int ci, int co, int hs, int ws) {
  const int tpr = (ws + fwd_p(co) - 1) / fwd_p(co);
  int r = FWD_THREADS / tpr;
  if (r < 1) r = 1;
  if (r > hs) r = hs;
  while (r > 1 && 4 * (long long)fwd_layout(ci, co, ws, r).floats > FWD_MAX_SMEM) --r;
  return r;
}

template <int N>
__device__ __forceinline__ void fwd_load(const float* src, float* dst) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    dst[0] = a.x;
    dst[1] = a.y;
    dst[2] = a.z;
    dst[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    dst[0] = a.x;
    dst[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <int N>
__device__ __forceinline__ void fwd_store(float* dst, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = float4{v[0], v[1], v[2], v[3]};
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = float2{v[0], v[1]};
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

// One step's place in the volume: batch element, query position, first
// support row of its tile.
struct FwdStep {
  int b, qi, qj, u0;
};

// Stage query column qc of step st into its ring slot: for each channel,
// query row qi (with the one-row support halo) and rows qi -+ 1, the tile's
// support rows that lie in the plane. With `bulk` (ws % 4 == 0 and 16-byte
// aligned pointers) each (channel, query row) is one contiguous run of
// support rows, copied by one TMA bulk copy (cp.async.bulk) that completes
// on the slot's mbarrier, armed by thread 0 with the column's bytes;
// otherwise threads copy whole rows themselves. Rows outside the support
// plane are written as zeros; query rows outside the plane are skipped
// (their taps read the zero region).
__device__ __forceinline__ void fwd_stage(const FwdLayout& L, float* smem,
                                          unsigned long long* bar, const float* x,
                                          const FwdStep& st, int qc, int ci_n, int hq,
                                          int wq, int hs, int ws, bool bulk) {
  const int tid = (int)threadIdx.x, rows = L.rows, u0 = st.u0;
  const long long S = (long long)hs * ws, QS = (long long)hq * wq * S;
  float* slot = smem + L.xs + (qc % FWD_SLOTS) * L.slot;
  const float* col = x + (st.b * (long long)ci_n * hq * wq + (long long)st.qi * wq + qc) * S;
  const int lo_o = u0, hi_o = u0 + rows < hs ? u0 + rows : hs;          // rows in the plane
  const int lo_c = u0 > 0 ? u0 - 1 : 0, hi_c = u0 + rows + 1 < hs ? u0 + rows + 1 : hs;
  const int rr_lo = st.qi > 0 ? 0 : 1, rr_hi = st.qi + 1 < hq ? 2 : 1;   // query rows in the plane
  if (bulk) {
    if (tid == 0) {
      const int n = (rr_hi - rr_lo) * (hi_o - lo_o) + (hi_c - lo_c);  // rows, all channels
      mbar_expect_tx(bar + qc % FWD_SLOTS, (unsigned)(n * ci_n * ws * 4));
    }
    fence_proxy_async();
    for (int j = tid; j < 3 * ci_n; j += L.threads) {
      const int c = j / 3, rr = j - 3 * c;
      if (rr < rr_lo || rr > rr_hi) continue;
      const bool centre = rr == 1;
      const int lo = centre ? lo_c : lo_o, hi = centre ? hi_c : hi_o;
      float* dst = slot + (rr == 0 ? 0 : (centre ? ci_n * L.csq : ci_n * (L.csq + L.csc))) +
                   c * (centre ? L.csc : L.csq) + (lo - (centre ? u0 - 1 : u0)) * L.ld;
      bulk_copy_g2s(dst, col + c * QS + (rr - 1) * (long long)wq * S + (long long)lo * ws,
                    (unsigned)((hi - lo) * ws * 4), bar + qc % FWD_SLOTS);
    }
  }
  // row by row: every row without `bulk`; only the rows outside the plane with it
  const int per = 3 * (rows + 2);
  for (int j = tid; j < ci_n * per; j += L.threads) {
    const int c = j / per, rr = (j - c * per) / (rows + 2), ur = j - c * per - rr * (rows + 2);
    const bool centre = rr == 1;
    if (rr < rr_lo || rr > rr_hi || (!centre && ur >= rows)) continue;
    const int u = (centre ? u0 - 1 : u0) + ur;
    const bool in = u >= 0 && u < hs;
    if (bulk && in) continue;
    float* dst = slot + (rr == 0 ? 0 : (centre ? ci_n * L.csq : ci_n * (L.csq + L.csc))) +
                 c * (centre ? L.csc : L.csq) + ur * L.ld;
    const float* src = col + c * QS + (rr - 1) * (long long)wq * S + (long long)u * ws;
    for (int v = 0; v < ws; ++v) dst[v] = in ? src[v] : 0.f;
  }
}

template <int CO>
__global__ void __launch_bounds__(FWD_THREADS)
pivot_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, int ci_n, int hq,
                 int wq, int hs, int ws, int batch, int rows, int relu, int bulk) {
  constexpr int P = fwd_p(CO);
  constexpr int COP = (CO + 3) / 4 * 4;
  FSS_SHARED(smem);
  const FwdLayout L = fwd_layout(ci_n, CO, ws, rows);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  const int tid = (int)threadIdx.x;
  const long long S = (long long)hs * ws, Q = (long long)hq * wq;
  const int tiles = (hs + rows - 1) / rows;

  // this CTA's steps: whole units round-robin, then an even share of the rest
  const long long G = gridDim.x, k = blockIdx.x;
  const long long units = (long long)batch * tiles * hq;
  const long long full = units / G;
  const long long n_rem = (units - full * G) * wq;
  const long long lo = n_rem * k / G, hi = n_rem * (k + 1) / G;
  const long long n_full = full * wq, n_steps = n_full + hi - lo;
  auto step_at = [&](long long i) {
    const long long t = i < n_full ? ((i / wq) * G + k) * wq + i % wq : full * G * wq + lo + (i - n_full);
    FwdStep st;
    st.qj = (int)(t % wq);
    long long r = t / wq;
    st.qi = (int)(r % hq);
    r /= hq;
    st.u0 = (int)(r % tiles) * rows;
    st.b = (int)(r / tiles);
    return st;
  };
  // Every bulk staging of a slot is waited on once, at the start of the
  // step that first reads it: `pend` holds the slots with copies in flight,
  // `parity` each slot barrier's phase to wait for (the same in all threads).
  unsigned pend = 0, parity = 0;
  auto stage = [&](const FwdStep& st, int qc) {
    fwd_stage(L, smem, bar, x, st, qc, ci_n, hq, wq, hs, ws, bulk);
    if (bulk) pend |= 1u << (qc % FWD_SLOTS);
  };
  auto stage_window = [&](const FwdStep& st) {  // a fresh run's first step
    for (int qc = st.qj > 0 ? st.qj - 1 : 0; qc <= st.qj + 1 && qc < wq; ++qc) stage(st, qc);
  };

  // the slots' barriers, the weights (co padded with zeros), the zero
  // region and the ring (row tails stay zero)
  if (tid == 0) {
    for (int i = 0; i < FWD_SLOTS; ++i) mbar_init(bar + i, 1);
    fence_mbar_init();
  }
  for (int i = tid; i < L.zr - L.w; i += L.threads) {
    const int co = i % COP;
    smem[L.w + i] = co < CO ? w[(i / COP) * CO + co] : 0.f;
  }
  for (int i = L.zr + tid; i < L.floats; i += L.threads) smem[i] = 0.f;
  float bv[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) bv[co] = bias[co];
  __syncthreads();

  // Pipeline, one step ahead: while step i computes, step i+1's new column
  // is in flight into the ring's fourth slot. A step that starts a fresh run
  // (qj = 0, or the first of the CTA's last share) stages its window after
  // step i's compute, whose slots it may reuse.
  FWD_PHASE_START();
  FwdStep cur = step_at(0);
  if (n_steps > 0) stage_window(cur);
  for (long long i = 0; i < n_steps; ++i) {
    const bool has_next = i + 1 < n_steps;
    const FwdStep nxt = has_next ? step_at(i + 1) : cur;
    const bool fresh = has_next && (i + 1 == n_full || nxt.qj == 0);
    unsigned ahead = 0;  // the slot staged for the next step: not waited on now
    if (has_next && !fresh && nxt.qj + 1 < wq) {
      stage(nxt, nxt.qj + 1);
      ahead = 1u << ((nxt.qj + 1) % FWD_SLOTS);
    }
    FWD_PHASE(0);
#pragma unroll
    for (int sl = 0; sl < FWD_SLOTS; ++sl)
      if ((pend & ~ahead) >> sl & 1) {
        mbar_wait(bar + sl, parity >> sl & 1);
        parity ^= 1u << sl;
      }
    pend &= ahead;
    __syncthreads();
    FWD_PHASE(1);

    // the query taps' sources: a staged row region, or the zero region
    int qb[9], qcs[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dh = t / 3 - 1, dw = t % 3 - 1;
      const int ii = cur.qi + dh, jj = cur.qj + dw;
      if (ii >= 0 && ii < hq && jj >= 0 && jj < wq) {
        qb[t] = L.xs + (jj % FWD_SLOTS) * L.slot +
                (dh < 0 ? 0 : (dh == 0 ? ci_n * L.csq + L.ld : ci_n * (L.csq + L.csc)));
        qcs[t] = dh == 0 ? L.csc : L.csq;
      } else {
        qb[t] = L.zr;
        qcs[t] = 0;
      }
    }
    const int cb = L.xs + (cur.qj % FWD_SLOTS) * L.slot + ci_n * L.csq + L.ld;

    for (int grp = tid; grp < rows * L.tpr; grp += L.threads) {
      const int ul = grp / L.tpr, v0 = (grp - ul * L.tpr) * P;
      const int u = cur.u0 + ul;
      if (u >= hs) break;
      const int toff = ul * L.ld + v0;
      const bool left = v0 > 0, right = v0 + P < ws;  // support neighbours in the plane
      float acc[P][CO];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[p][co] = bv[co];

      for (int c = 0; c < ci_n; ++c) {
        const float* wc = smem + L.w + c * 18 * COP;
#pragma unroll
        for (int t = 0; t < 9; ++t) {  // query plane: the staged window
          float xv[P], wv[COP];
          fwd_load<P>(smem + qb[t] + c * qcs[t] + toff, xv);
#pragma unroll
          for (int j = 0; j < COP; j += 4) fwd_load<4>(wc + t * COP + j, wv + j);
#pragma unroll
          for (int co = 0; co < CO; ++co)
#pragma unroll
            for (int p = 0; p < P; ++p) acc[p][co] = fmaf(wv[co], xv[p], acc[p][co]);
        }
        const float* cr = smem + cb + c * L.csc + toff;
#pragma unroll
        for (int du = 0; du < 3; ++du) {  // support plane: the centre row's halo
          const float* r = cr + (du - 1) * L.ld;
          float xv[P + 2];
          xv[0] = left ? r[-1] : 0.f;
          fwd_load<P>(r, xv + 1);
          xv[P + 1] = right ? r[P] : 0.f;
#pragma unroll
          for (int dv = 0; dv < 3; ++dv) {
            float wv[COP];
#pragma unroll
            for (int j = 0; j < COP; j += 4) fwd_load<4>(wc + (9 + du * 3 + dv) * COP + j, wv + j);
#pragma unroll
            for (int co = 0; co < CO; ++co)
#pragma unroll
              for (int p = 0; p < P; ++p) acc[p][co] = fmaf(wv[co], xv[p + dv], acc[p][co]);
          }
        }
      }

      float* yb = y + (cur.b * (long long)CO * Q + (long long)cur.qi * wq + cur.qj) * S +
                  (long long)u * ws + v0;
#pragma unroll
      for (int co = 0; co < CO; ++co) {
        float out[P];
#pragma unroll
        for (int p = 0; p < P; ++p) out[p] = relu ? fmaxf(acc[p][co], 0.f) : acc[p][co];
        float* yo = yb + co * Q * S;
        if (bulk) {
          fwd_store<P>(yo, out);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p)
            if (v0 + p < ws) yo[p] = out[p];
        }
      }
    }
    __syncthreads();  // the next step's copy overwrites this step's oldest column
    FWD_PHASE(2);
    if (fresh) stage_window(nxt);
    FWD_PHASE(3);
    cur = nxt;
  }
  FWD_PHASE_END();
}
