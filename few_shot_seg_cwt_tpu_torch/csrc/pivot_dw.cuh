// pivot_dw: the weight and bias gradients of the centre-pivot pair on
// Hopper's tensor cores, 3xTF32, as a warp-specialised pipeline. The design
// and what bounds it are in the note at the top of pivot.cu.
//
// This header is included by pivot.cu (inside its namespace) and by
// pivot_dw_emulated.cpp, which runs the same kernel on the CPU through
// cuda_emulation.h. Device intrinsics come from the includer: mma_tf32,
// tf32_rna (cvt.rna.tf32.f32), bulk_copy_g2s, mbar_init, mbar_expect_tx,
// mbar_arrive, mbar_wait, fence_mbar_init, fence_proxy_async,
// mma_warps_sync (a barrier of the DW_MMA_WARPS warps alone),
// __syncthreads, __syncwarp, FSS_SHARED, DW_CLOCK() (clock64() in
// pivot.cu's -DFSS_PHASE_CLOCKS build, else 0) and DW_PHASES_END(ph) (adds
// the counters to the CTA's row in that build).

constexpr int DW_MMA_WARPS = 12;                 // the consumers: landed stages -> MMAs
constexpr int DW_PRODUCER = DW_MMA_WARPS;        // the producer warp's index
constexpr int DW_THREADS = 32 * (DW_PRODUCER + 1);           // 416: one CTA an SM
constexpr int DW_MT_PER_WARP = 4;                // m16 tiles an MMA warp owns
constexpr int DW_MAX_ROWS = 8;                   // support rows a step, at most
constexpr int DW_MIN_SLOTS = 4, DW_MAX_SLOTS = 6;   // column slots: the window's 3 and 1-3 ahead
constexpr int DW_MAX_CI = 42;                    // 18*42+1 rows: 48 m-tiles, 12 warp groups
constexpr int DW_MAX_SMEM = 232448;              // shared memory one Hopper block may use
constexpr int DW_ZERO_FLOATS = 4096;             // the zero rows' source, 16 KB
constexpr int DW_PHASES = 4;  // consumers' wait, producer's wait, producer's issue, MMAs
constexpr int DW_FLUSH_ROWS = 16;  // support rows an MMA warp's fragments sum before its
                                   // running sums: ~100 MMAs into one accumulator

// The source of rows outside the support plane: the producer copies them
// from here, so every staged row arrives by the same copies.
__device__ float4 fss_dw_zero_rows[DW_ZERO_FLOATS / 4];

// A stride of 4 * odd floats puts 8 consecutive channels on 8 distinct
// 4-bank groups: the lanes of a fragment load do not collide.
__host__ __device__ inline int pad_banks(int n) { return n + ((12 - n % 8) % 8); }

// Shared-memory layout of pivot_dw_mma_kernel, in floats (the same on the
// host and the device): the mbarriers, A's sources (the zero region, the
// ones region, the ring of staged columns), the ring of g tiles, a zero row,
// the tables. Staged rows are contiguous, ws floats apart, as in x. Offsets
// are multiples of 4 (16-byte copies).
struct DwLayout {
  int rows;       // R: whole support rows a step
  int nc, ng;     // column slots; g slots (nc - 2)
  int csq, csc;   // per-channel stride: query-row buffers (R rows) and
                  // centre-row buffers (R + 2 rows, with the halo)
  int slot;       // one staged column: 3 query rows x ci channels
  int zr;         // the zero region and the ones region, zr floats each
  int za, xs;     // offsets of the zero region and of the ring of nc columns
  int kp, ldg;    // positions a step (K, a multiple of 8); g's row stride
  int gslot;      // a g slot: co rows
  int gs;         // offset of the ring of ng g slots
  int gzero;      // a zero row: the B rows of the padding output channels
  int edge;       // offset of the edge table: a position's flags, kp ints
  int bufs;       // buffers a column stages, 3 a channel
  int buftab;     // offset of the staging table: 3 ints a buffer
  int mg, ks;     // warp groups of DW_MT_PER_WARP m16 tiles; k-splits
  int n_out;      // (18*ci + 1) * co: dW then db
  int floats;     // all of it, or the warps' partial sums at the end
};

__host__ __device__ inline DwLayout dw_layout(int ci, int co, int ws, int rows, int nc) {
  DwLayout l;
  l.rows = rows;
  l.nc = nc;
  l.ng = nc - 2;
  l.csq = pad_banks(rows * ws);
  l.csc = pad_banks((rows + 2) * ws);
  l.slot = ci * (2 * l.csq + l.csc);
  l.kp = (rows * ws + 7) / 8 * 8;
  // a frame: row -1 to row R, or to the last padded position
  const int frame = (rows + 2) * ws > l.kp + ws ? (rows + 2) * ws : l.kp + ws;
  l.zr = (frame + 3) / 4 * 4;
  l.za = (2 * 2 * (l.nc + l.ng) + 3) / 4 * 4;  // after the mbarriers (8 bytes each)
  l.xs = l.za + 2 * l.zr;
  l.ldg = pad_banks(l.kp);
  l.gslot = co * l.ldg;
  l.gs = l.xs + l.nc * l.slot;
  l.gzero = l.gs + l.ng * l.gslot;
  l.edge = l.gzero + l.ldg;
  l.bufs = 3 * ci;
  l.buftab = l.edge + l.kp;
  const int m_tiles = (18 * ci + 1 + 15) / 16;
  l.mg = (m_tiles + DW_MT_PER_WARP - 1) / DW_MT_PER_WARP;
  l.ks = l.mg <= DW_MMA_WARPS ? DW_MMA_WARPS / l.mg : 0;
  l.n_out = (18 * ci + 1) * co;
  const int staging = l.buftab + 3 * l.bufs;
  const int partials = l.za + l.ks * l.n_out;
  l.floats = staging > partials ? staging : partials;
  return l;
}

// The layout a shape runs: the most support rows a step (at most
// DW_MAX_ROWS) that fit a block with DW_MIN_SLOTS column slots, then as many
// slots as fit (at most DW_MAX_SLOTS). If even one row does not fit, the
// one-row layout, which the caller refuses.
__host__ __device__ inline DwLayout dw_plan(int ci, int co, int ws) {
  for (int rows = DW_MAX_ROWS; rows > 0; --rows) {
    if (4LL * dw_layout(ci, co, ws, rows, DW_MIN_SLOTS).floats > DW_MAX_SMEM) continue;
    int nc = DW_MIN_SLOTS;
    while (nc < DW_MAX_SLOTS && 4LL * dw_layout(ci, co, ws, rows, nc + 1).floats <= DW_MAX_SMEM)
      ++nc;
    return dw_layout(ci, co, ws, rows, nc);
  }
  return dw_layout(ci, co, ws, 1, DW_MIN_SLOTS);
}

// One step: batch element, query position, first support row of its tile.
struct DwStep {
  int b, qi, qj, u0;
};

// A CTA's steps, the same in every role. A unit is one query row's walk
// along qj at one support tile; units are numbered with qi fastest, then the
// tile, then b, and dealt out round-robin, so CTAs that run at the same time
// stage neighbouring query rows of one tile and a column staged by one is
// still in L2 when the CTAs on rows qi-1 and qi+1 stage it. The units left
// after the full rounds are split evenly, step by step, over all CTAs.
struct DwSeq {
  int grid, k, n_full, lo, full;
  int hq, wq, tiles, rows;
  int n;  // the CTA's steps

  __device__ DwSeq(int batch, int hq_, int wq_, int hs, int rows_)
      : hq(hq_), wq(wq_), tiles((hs + rows_ - 1) / rows_), rows(rows_) {
    grid = (int)gridDim.x;
    k = (int)blockIdx.x;
    const int units = batch * tiles * hq;
    full = units / grid;
    const long long n_rem = (long long)(units - full * grid) * wq;
    lo = (int)(n_rem * k / grid);
    const int hi = (int)(n_rem * (k + 1) / grid);
    n_full = full * wq;
    n = n_full + hi - lo;
  }
  __device__ DwStep at(int i) const {
    const long long t = i < n_full ? ((long long)(i / wq) * grid + k) * wq + i % wq
                                   : (long long)full * grid * wq + lo + (i - n_full);
    DwStep st;
    st.qj = (int)(t % wq);
    long long r = t / wq;
    st.qi = (int)(r % hq);
    r /= hq;
    st.u0 = (int)(r % tiles) * rows;
    st.b = (int)(r / tiles);
    return st;
  }
  // step i + 1, from step i = cur: the next qj of the same run where there
  // is one (no division), else decoded
  __device__ DwStep next(int i, const DwStep& cur) const {
    if (cur.qj + 1 < wq && i + 1 != n_full) {
      DwStep st = cur;
      ++st.qj;
      return st;
    }
    return at(i + 1);
  }
};

// Does step `b` continue step `a`'s run of qj?
__device__ __forceinline__ bool dw_continues(const DwStep& a, const DwStep& b) {
  return b.b == a.b && b.qi == a.qi && b.u0 == a.u0 && b.qj == a.qj + 1;
}

// The staged columns, in the order the producer stages them, the same in
// every role: a run's first step stages its window (qj-1..qj+1 in the
// plane), every later step the column qj+1. Column c of the current run
// has sequence number base + c - c0 and sits in ring slot number % nc.
struct DwCols {
  int next_seq = 0;   // the next staged column's number
  int base = 0, c0 = 0;
  int lo = 0, hi = -1;  // this step's new columns lo..hi

  __device__ void step(const DwStep& st, bool fresh, int wq) {
    if (fresh) {
      c0 = st.qj > 0 ? st.qj - 1 : 0;
      base = next_seq;
      lo = c0;
    } else {
      lo = st.qj + 1;
    }
    hi = st.qj + 1 < wq ? st.qj + 1 : wq - 1;
    if (hi >= lo) next_seq += hi - lo + 1;
  }
  __device__ int seq(int c) const { return base + c - c0; }
};

// The producer: copy `n` floats (a run of staged rows) from src, or zeros
// where src is null; by TMA bulk copies on `bar` with `bulk`, else by this
// lane.
__device__ __forceinline__ void dw_copy_row(float* dst, const float* src, int n,
                                            unsigned long long* bar, bool bulk) {
  if (bulk) {
    for (int o = 0; o < n; o += DW_ZERO_FLOATS) {
      const int m = n - o < DW_ZERO_FLOATS ? n - o : DW_ZERO_FLOATS;
      bulk_copy_g2s(dst + o, src ? src + o : reinterpret_cast<const float*>(fss_dw_zero_rows),
                    (unsigned)(4 * m), bar);
    }
  } else {
    for (int v = 0; v < n; ++v) dst[v] = src ? src[v] : 0.f;
  }
}

// The producer warp stages query column c of step st into ring slot s: for
// each channel, query row qi with its one-row support halo and rows qi -+ 1
// where they lie in the plane, each one contiguous run of support rows: one
// copy of the rows in the support plane, and the rows outside it from the
// zero rows, all completing on the slot's full barrier. Query rows outside
// the plane are not staged (their taps read the zero region).
__device__ __forceinline__ void dw_stage_column(const DwLayout& L, float* smem,
                                                unsigned long long* full, const float* x,
                                                const DwStep& st, int c, int s, int ci_n,
                                                int hq, int wq, int hs, int ws, bool bulk) {
  const int lane = threadIdx.x & 31;
  const int* tab = reinterpret_cast<const int*>(smem + L.buftab);
  const long long S = (long long)hs * ws, Q = (long long)hq * wq;
  const float* col = x + (st.b * (long long)ci_n * Q + (long long)st.qi * wq + c) * S +
                     (long long)st.u0 * ws;
  float* slot = smem + L.xs + s * L.slot;
  const int rr_lo = st.qi > 0 ? 0 : 1, rr_hi = st.qi + 1 < hq ? 2 : 1;
  auto buffers = [&] {
    for (int j = lane; j < L.bufs; j += 32) {
      const int* e = tab + 3 * j;
      const int rr = e[2];
      if (rr < rr_lo || rr > rr_hi) continue;
      const int first = st.u0 - (rr == 1), n = L.rows + 2 * (rr == 1);  // its support rows
      const int lo = first > 0 ? first : 0, hi = first + n < hs ? first + n : hs;
      float* dst = slot + e[0];
      if (lo > first) dw_copy_row(dst, nullptr, (lo - first) * ws, full, bulk);
      dw_copy_row(dst + (lo - first) * ws, col + e[1] + (lo - first) * (long long)ws,
                  (hi - lo) * ws, full, bulk);
      if (hi < first + n) dw_copy_row(dst + (hi - first) * ws, nullptr, (first + n - hi) * ws,
                                      full, bulk);
    }
  };
  if (!bulk) buffers();
  __syncwarp();
  if (lane == 0) {  // the arrival, with the bytes the copies will bring
    const int n = ci_n * ((rr_hi - rr_lo) * L.rows + L.rows + 2);
    mbar_expect_tx(full, bulk ? (unsigned)(4 * n * ws) : 0u);
  }
  __syncwarp();
  if (bulk) buffers();
}

// The producer warp stages g's tile of step st into g slot `gb`: R support
// rows of each output channel at query position (qi, qj), contiguous in g
// and in the slot; rows past the support plane from the zero rows.
template <int CO>
__device__ __forceinline__ void dw_stage_g(const DwLayout& L, float* gb,
                                           unsigned long long* full, const float* g,
                                           const DwStep& st, int hq, int wq, int hs, int ws,
                                           bool bulk) {
  const int lane = threadIdx.x & 31;
  const long long S = (long long)hs * ws, Q = (long long)hq * wq;
  const int in = hs - st.u0 < L.rows ? hs - st.u0 : L.rows;  // rows in the plane
  auto rows = [&] {
    for (int co = lane; co < CO; co += 32) {
      const float* src =
          g + ((st.b * (long long)CO + co) * Q + (long long)st.qi * wq + st.qj) * S +
          (long long)st.u0 * ws;
      dw_copy_row(gb + co * L.ldg, src, in * ws, full, bulk);
      if (in < L.rows)
        dw_copy_row(gb + co * L.ldg + in * ws, nullptr, (L.rows - in) * ws, full, bulk);
    }
  };
  if (!bulk) rows();
  __syncwarp();
  if (lane == 0) mbar_expect_tx(full, bulk ? (unsigned)(4 * CO * L.rows * ws) : 0u);
  __syncwarp();
  if (bulk) rows();
}

// An MMA warp's k-chunks of one step: chunks k0 = begin, begin + stride, ...
// below end; `kill`, byte f: the rows (bit 2 mt + h) whose value at a
// position with edge flags f is 0.
struct DwChunks {
  int begin, end, stride;
  unsigned kill;
};

// 3xTF32's split of a landed value a = big + small, both TF32: big =
// cvt.rna.tf32(a); small = cvt.rna.tf32(a - big), rounded by the integer
// step cvt.rna takes on a finite value (to nearest, ties away: add 0x1000,
// clear the low 13 bits), which a - big is wherever a is finite (and NaN,
// which stays NaN, where it is not). `zero` gives 0's parts.
__device__ __forceinline__ void split_tf32(float a, bool zero, uint32_t& big, uint32_t& small) {
  const float v = zero ? 0.f : a;
  big = tf32_rna(v);
  small = (__float_as_uint(v - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// One step's MMAs of an MMA warp: its NMT m-tiles (rows of A from a[mt][h],
// the row's value at position p at a[mt][h][p]) times every n-tile (B's rows
// from b[nt]), 3xTF32 into acc. Each value is split into its TF32 parts as
// it is loaded; a support tap that steps off a row's end (dv = -1 at v = 0,
// dv = +1 at v = ws - 1) reads the next row's value in the contiguous rows,
// and `kill` makes it 0 (edge[p]: p's flags). A tile's three products into
// one accumulator are NT MMAs apart.
template <int CO, int NMT>
__device__ __forceinline__ void dw_mma_chunks(const float* const (&a)[DW_MT_PER_WARP][2],
                                              const float* const (&b)[(CO + 7) / 8],
                                              const int* edge, const DwChunks& ch,
                                              float (&acc)[DW_MT_PER_WARP][(CO + 7) / 8][4]) {
  constexpr int NT = (CO + 7) / 8;
  for (int k0 = ch.begin; k0 < ch.end; k0 += ch.stride) {
    const unsigned kill0 = ch.kill >> (8 * edge[k0]), kill1 = ch.kill >> (8 * edge[k0 + 4]);
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split_tf32(b[nt][k0], false, bb[nt][0], bs[nt][0]);
      split_tf32(b[nt][k0 + 4], false, bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      uint32_t ab[4], as[4];
      split_tf32(a[mt][0][k0], kill0 >> (2 * mt) & 1, ab[0], as[0]);
      split_tf32(a[mt][1][k0], kill0 >> (2 * mt + 1) & 1, ab[1], as[1]);
      split_tf32(a[mt][0][k0 + 4], kill1 >> (2 * mt) & 1, ab[2], as[2]);
      split_tf32(a[mt][1][k0 + 4], kill1 >> (2 * mt + 1) & 1, ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], as, bb[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ab, bs[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ab, bb[nt]);
    }
  }
}

// The weight gradient. Warps 0-11 multiply, warp 12 stages (see pivot.cu's
// note); both roles walk the CTA's steps in the same order.
template <int CO>
__global__ void __launch_bounds__(DW_THREADS, 1)
pivot_dw_mma_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ partial, int ci_n, int hq, int wq, int hs, int ws,
                    int batch, int rows, int nc, int bulk) {
  constexpr int NT = (CO + 7) / 8;  // n8 tiles
  constexpr int MT = DW_MT_PER_WARP;
  FSS_SHARED(smem);
  const DwLayout L = dw_layout(ci_n, CO, ws, rows, nc);
  // full (landed) and empty (read) barriers: columns 0..nc-1, g slots nc..
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + L.nc + L.ng;
  int* edge = reinterpret_cast<int*>(smem + L.edge);
  int* tab = reinterpret_cast<int*>(smem + L.buftab);
  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DwSeq seq(batch, hq, wq, hs, rows);

  for (int i = L.za + tid; i < L.floats; i += DW_THREADS) smem[i] = 0.f;
  if (tid == 0) {
    for (int i = 0; i < L.nc + L.ng; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, DW_MMA_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  for (int i = L.za + L.zr + tid; i < L.za + 2 * L.zr; i += DW_THREADS) smem[i] = 1.f;
  // the edge table, once a CTA: position p's flags, v = 0 (1) and v = ws - 1
  // (2); the padding positions' none (g is 0 there)
  for (int p = tid; p < L.kp; p += DW_THREADS) {
    const int v = p - (p / ws) * ws;
    edge[p] = p < rows * ws ? (v == 0) | ((v == ws - 1) << 1) : 0;
  }
  // the staging table, once a CTA: a column's buffer j (channel c, query
  // row rr) -> its offset in the slot, its source from the column's value
  // at support row u0 (the centre's one row above), rr
  const long long S = (long long)hs * ws, Q = (long long)hq * wq;
  for (int j = tid; j < L.bufs; j += DW_THREADS) {
    int* e = tab + 3 * j;
    const int c = j / 3, rr = j - 3 * c;
    e[0] = rr == 0 ? c * L.csq : (rr == 1 ? ci_n * L.csq + c * L.csc
                                          : ci_n * (L.csq + L.csc) + c * L.csq);
    e[1] = (int)(c * Q * S + (rr - 1) * wq * S - (rr == 1 ? ws : 0));
    e[2] = rr;
  }
  fence_proxy_async();  // the zeros above before any bulk copy lands
  __syncthreads();

  unsigned long long ph[DW_PHASES] = {};
  DwCols cols;
  DwStep cur = seq.at(0);
  bool fresh = true;
  int gslot = 0, guse = 0;  // the step's g slot, and how often it has been used

  // the MMA warps' share: m-tiles mg*MT .. mg*MT+MT-1 (those below m_tiles)
  // for k-chunks ks, ks+KS, ...
  const int m_tiles = (18 * ci_n + 1 + 15) / 16;
  const int mg = L.ks ? warp / L.ks : DW_MMA_WARPS;
  const int ks = L.ks ? warp - mg * L.ks : 0;
  const bool mma_warp = warp < DW_MMA_WARPS && mg < L.mg;
  const int nmt = mma_warp ? min(MT, m_tiles - mg * MT) : 0;
  const int grp = lane >> 2, tig = lane & 3;  // the mma fragments' row / column

  if (warp == DW_PRODUCER) {
    // ---- the producer: each step's new columns, then its g tile ------------
    for (int i = 0; i < seq.n; ++i) {
      const bool has_next = i + 1 < seq.n;
      const DwStep nxt = has_next ? seq.next(i, cur) : cur;
      cols.step(cur, fresh, wq);
      for (int c = cols.lo; c <= cols.hi; ++c) {
        const int n = cols.seq(c), s = n % L.nc;
        long long t0 = DW_CLOCK();
        if (n >= L.nc) mbar_wait(empty + s, (n / L.nc - 1) & 1);
        if (lane == 0) {
          const long long t1 = DW_CLOCK();
          ph[1] += t1 - t0;
          t0 = t1;
        }
        dw_stage_column(L, smem, full + s, x, cur, c, s, ci_n, hq, wq, hs, ws, bulk);
        if (lane == 0) ph[2] += DW_CLOCK() - t0;
      }
      long long t0 = DW_CLOCK();
      if (i >= L.ng) mbar_wait(empty + L.nc + gslot, (guse - 1) & 1);
      if (lane == 0) {
        const long long t1 = DW_CLOCK();
        ph[1] += t1 - t0;
        t0 = t1;
      }
      dw_stage_g<CO>(L, smem + L.gs + gslot * L.gslot, full + L.nc + gslot, g, cur, hq, wq, hs,
                     ws, bulk);
      if (lane == 0) ph[2] += DW_CLOCK() - t0;
      if (++gslot == L.ng) gslot = 0, ++guse;
      fresh = !has_next || !dw_continues(cur, nxt);
      cur = nxt;
    }
    DW_PHASES_END(ph);
  } else {
    // ---- the MMA warps ------------------------------------------------------
    // the taps of this thread's 8 rows of A: 0-8 query, 9-17 support, 18 the
    // ones row, 19 padding; and their channel. A support tap with dv = -1
    // reads 0 at a position with v = 0 (edge flag 1), dv = +1 at v = ws - 1
    // (flag 2): byte f of `kill` marks the rows zeroed at flags f.
    int tap[MT][2], chan[MT][2];
    unsigned kill = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mg * MT + mt) * 16 + grp + 8 * h;
        tap[mt][h] = m < 18 * ci_n ? m / ci_n : (m == 18 * ci_n ? 18 : 19);
        chan[mt][h] = m < 18 * ci_n ? m - (m / ci_n) * ci_n : 0;
        const int tp = tap[mt][h], dv = (tp - 9) % 3 - 1;
        const int edge = tp >= 9 && tp < 18 ? (dv < 0 ? 1 : (dv > 0 ? 2 : 0)) : 0;
        for (int f = 1; f < 4; ++f)
          if (edge & f) kill |= 1u << (8 * f + 2 * mt + h);
      }
    // the fragments' sums over DW_FLUSH_ROWS support rows of steps, then
    // added to the running sums
    const int flush = rows < DW_FLUSH_ROWS ? DW_FLUSH_ROWS / rows : 1;
    int since = 0;
    float acc[MT][NT][4], run[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = run[mt][nt][e] = 0.f;
    for (int i = 0; i < seq.n; ++i) {
      const bool has_next = i + 1 < seq.n;
      const DwStep nxt = has_next ? seq.next(i, cur) : cur;
      const bool next_fresh = !has_next || !dw_continues(cur, nxt);
      cols.step(cur, fresh, wq);
      long long t0 = DW_CLOCK();
      for (int c = cols.lo; c <= cols.hi; ++c) {
        const int n = cols.seq(c);
        mbar_wait(full + n % L.nc, (n / L.nc) & 1);
      }
      mbar_wait(full + L.nc + gslot, guse & 1);
      if (tid == 0) {
        const long long t1 = DW_CLOCK();
        ph[0] += t1 - t0;
        t0 = t1;
      }
      const int qi = cur.qi, qj = cur.qj;
      if (mma_warp) {
        // this step's base offset of each of the thread's rows of A
        const int s_prev = qj > 0 ? cols.seq(qj - 1) % L.nc : 0, s_mid = cols.seq(qj) % L.nc,
                  s_next = qj + 1 < wq ? cols.seq(qj + 1) % L.nc : 0;
        int base[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tp = tap[mt][h], c = chan[mt][h];
            int o = L.za;  // the zero region
            if (tp < 9) {
              const int dh = tp / 3 - 1, dw = tp % 3 - 1;
              if (qi + dh >= 0 && qi + dh < hq && qj + dw >= 0 && qj + dw < wq) {
                const int s = dw < 0 ? s_prev : (dw == 0 ? s_mid : s_next);
                o = L.xs + s * L.slot +
                    (dh < 0 ? c * L.csq - ws
                            : (dh == 0 ? ci_n * L.csq + c * L.csc
                                       : ci_n * (L.csq + L.csc) + c * L.csq - ws));
              }
            } else if (tp < 18) {
              const int du = (tp - 9) / 3 - 1, dv = (tp - 9) % 3 - 1;
              o = L.xs + s_mid * L.slot + ci_n * L.csq + c * L.csc + du * ws + dv;
            } else if (tp == 18) {
              o = L.za + L.zr;  // the ones region: this row gives db
            }
            base[mt][h] = o;
          }
        // B's rows: output channel n's, or the zero row; each row's value at
        // position p sits at [p], A's in its frame's row 0 onwards
        const float* brow[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = nt * 8 + grp;
          brow[nt] = smem + (n < CO ? L.gs + gslot * L.gslot + n * L.ldg : L.gzero) + tig;
        }
        const float* arow[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) arow[mt][h] = smem + base[mt][h] + ws + tig;
        const DwChunks ch = {ks * 8, L.kp, L.ks * 8, kill};
        switch (nmt) {  // the warp's m-tiles, each count unrolled
          case 4: dw_mma_chunks<CO, 4>(arow, brow, edge + tig, ch, acc); break;
          case 3: dw_mma_chunks<CO, 3>(arow, brow, edge + tig, ch, acc); break;
          case 2: dw_mma_chunks<CO, 2>(arow, brow, edge + tig, ch, acc); break;
          default: dw_mma_chunks<CO, 1>(arow, brow, edge + tig, ch, acc); break;
        }
        if (++since == flush || !has_next) {
          since = 0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                run[mt][nt][e] += acc[mt][nt][e];
                acc[mt][nt][e] = 0.f;
              }
        }
      }
      // release the g tile and the columns the next step does not read
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty + L.nc + gslot);
        const int c_lo = qj - 1 > cols.c0 ? qj - 1 : cols.c0;
        const int c_hi = next_fresh ? (qj + 1 < wq ? qj + 1 : wq - 1) : qj - 1;
        for (int c = c_lo; c <= c_hi; ++c) mbar_arrive(empty + cols.seq(c) % L.nc);
      }
      if (tid == 0) ph[3] += DW_CLOCK() - t0;
      if (++gslot == L.ng) gslot = 0, ++guse;
      fresh = next_fresh;
      cur = nxt;
    }
    DW_PHASES_END(ph);
    // the k-splits' sums, added in a fixed order into the CTA's partial row.
    // Once every MMA warp is past its last step, every stage has landed and
    // been read, so the staging area is free; the other warps are done.
    float* red = smem + L.za;
    mma_warps_sync();
    if (mma_warp) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // padding rows and columns are dropped
            const int m = (mg * MT + mt) * 16 + grp + (e >= 2 ? 8 : 0);
            const int co = nt * 8 + 2 * tig + (e & 1);
            if (m <= 18 * ci_n && co < CO) red[ks * L.n_out + m * CO + co] = run[mt][nt][e];
          }
    }
    mma_warps_sync();
    for (int j = tid; j < L.n_out; j += 32 * DW_MMA_WARPS) {
      float sum = 0.f;
      for (int k = 0; k < L.ks; ++k) sum += red[k * L.n_out + j];
      partial[(size_t)blockIdx.x * L.n_out + j] = sum;
    }
  }
}
