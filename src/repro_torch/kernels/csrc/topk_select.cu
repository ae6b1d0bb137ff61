// The fused two-pass counting select on Hopper (sm_90a): K1 pass-1
// histogram + block-min summary, K2 pass-2 in-order emit.
//
// K1 replaces src/repro/kernels/topk_select.py::_hist_kernel
// (hamming_hist_pallas); K2 replaces ::_emit_kernel (hamming_emit_pallas).
// Both compute what the Pallas kernels compute, on the same (bq, bn) tiles,
// so the histogram, the (Q/bq, N/bn) block-min summary and the emitted
// (dists, ids) slots are bit-identical to them and to the plain PyTorch
// versions in topk_select.py, whose `geometry` chooses (bq, bn).
//
// What bounds them on this card: the distances. At Q=4096, N=2^20, d=256
// a pass scores 4.3e9 (query, row) pairs from only ~0.03 GB of codes, so
// both are bound by operations, not bytes. On the CUDA cores a pair costs
// W = 8 popcounts (16 a clock per SM: ~8 ms a pass). On the tensor cores
// the same distances cost 2*Q*N*d int8 operations (~1 ms a pass at the
// data sheet's 1,979 TOP/s), or 1/8 of those instructions as single-bit
// products. K1 then adds one shared-memory atomic a pair; K2 ranks the
// rows of the tiles its block-min summary cannot skip.
//
// Runs. The N tiles split into R runs of ceil(N/bn / R) tiles (the last
// may be empty); each kernel runs one CTA per (run, query block). K1 can
// store each run's histogram (Q, R, bins); from it the caller derives each
// (query, run)'s first below-r* slot and first tie slot (exclusive scans
// over the runs, as repro's sharded hist_merge does over shards), and K2
// numbers each run's winners from those bases. So K2's slot order stays
// global row order while it runs 128 x 16 CTAs at the main shape, not one
// CTA per query block (128 CTAs on 132 SMs).
//
// d = 1024, 256, 128 and 64 (W = 32, 8, 4, 2; bq <= 32 at W = 32, else
// bq <= 64) run on the tensor cores, through mma.sync on single bits: a
// warp's tile is the query block (m16 fragments held in registers for the
// whole CTA) against an n8 chunk of data rows, one load a lane (two at
// W = 32), and popc(q & ~x) + popc(~q & x) is the distance itself, with no
// conversion of the packed words: two m16n8k256 AND-popc products at
// d = 256, and that pair on each of the four 256-bit quarters at d = 1024
// (eight); one at d = 128, whose 256 k-bits hold [q, ~q] against [~x, x];
// one m16n8k128 product at d = 64, whose 128 k-bits hold the same. On the
// H100 it beat both the CUDA-core kernels and a +-1 int8 product (m16n8k32
// on bits expanded to bytes), which was measured and dropped (PERF.md).
// Other widths and wider query blocks take the CUDA-core kernels, with the
// query row in registers at W = 8. At d = 1024 the 1025 bins keep bq at
// 16, so each query block rereads the whole store from L2 in each pass:
// at 4096 x 2^20 serving every load from L1 took 24 % off K1 and 21 % off
// K2, taking K1's products out 34 % (chip_topk_routes.py); those rereads
// and the eight products a fragment bound the tile there together.
// The codes go straight from L2 to the fragments, without a cp.async ring
// in shared memory: a lane's B operand is 4 to 32 contiguous bytes of a row,
// used once per CTA by all of its query fragments, so a ring would add a
// store and a load per byte and no reuse; and timing builds with parts of
// the work taken out (chip_topk_routes.py) found neither the loads, nor
// the products, nor the shared atomics alone setting K1's time.
//
// K1 (tensor cores): 8 warps take a tile's n8 chunks in turn, each
//     prefetching its next chunk while it scores the current one, and add
//     each distance into a bq x bins int32 shared histogram with shared
//     atomics (integer adds commute, so the result equals the Pallas
//     grid's sequential sum). The tile's block-min is a warp reduction and
//     a shared atomicMin. At the end the CTA adds its histogram into the
//     global one (atomics: a query block's runs meet there) and stores it
//     whole as its row of the per-run slab. A disabled tile writes `bins`
//     and adds nothing.
// K2 (tensor cores): the CTA walks its run's tiles in order, a tile in
//     equal chunks of at most 512 rows (256 at bq > 32). Phase A scores a
//     chunk into shared memory (uint16 a pair; each warp loads all of its
//     n8 pieces before it scores any) and keeps each query's least
//     distance there; phase B ranks, warp w taking queries w, w+8, ...: a
//     query whose least distance exceeds its r* costs one shared load,
//     the others are ranked 32 rows a step with __ballot_sync +
//     __popc(mask & lanemask). The codes are read once per CTA, not once
//     per warp.
// K1, K2 (CUDA cores): thread t of K1 owns query t % bq and walks rows
//     t / bq, +R, ... of each tile; warp w of K2 owns queries w, w+nwarps,
//     ... and scores 32 rows a step itself.
// In K2 a tile is skipped, uniformly for the CTA, when it is disabled or
// its block-min exceeds the widest r* of the query block (padded query
// rows carry r* = -1 and never raise it). Slots are written with plain
// stores; untouched slots keep the zeros the wrapper allocated. Given a
// counter (a profiler records), each CTA's warp 0 ends by counting its
// run's skipped tiles through the same guard and adds them with one
// atomic; a null counter adds no store and no launch.
//
// Plain C entry points, loaded with ctypes. Each launcher returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute) as an int;
// topk_tc_route returns the route of a launch.

#include <cuda_runtime.h>
#include <climits>

namespace {

// One query's packed row. W > 0: W words held in registers, rows read as
// 16-byte vectors (W % 4 == 0); W == 0: any width, read through the
// read-only cache.
template <int W>
struct QRow {
  static_assert(W % 4 == 0, "register rows are read as int4 vectors");
  unsigned w[W];

  __device__ __forceinline__ void load(const int* p, int) {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = static_cast<unsigned>(__ldg(p + i));
  }

  __device__ __forceinline__ int dist(const int* x, int) const {
    const int4* x4 = reinterpret_cast<const int4*>(x);
    int d = 0;
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const int4 v = __ldg(x4 + i);
      d += __popc(w[4 * i] ^ static_cast<unsigned>(v.x));
      d += __popc(w[4 * i + 1] ^ static_cast<unsigned>(v.y));
      d += __popc(w[4 * i + 2] ^ static_cast<unsigned>(v.z));
      d += __popc(w[4 * i + 3] ^ static_cast<unsigned>(v.w));
    }
    return d;
  }
};

template <>
struct QRow<0> {
  const int* p;

  __device__ __forceinline__ void load(const int* q, int) { p = q; }

  __device__ __forceinline__ int dist(const int* x, int nw) const {
    int d = 0;
    for (int i = 0; i < nw; ++i)
      d += __popc(static_cast<unsigned>(__ldg(p + i) ^ __ldg(x + i)));
    return d;
  }
};

// Tiles per run: run r covers tiles [r * span, min((r + 1) * span, N/bn)),
// empty for the last runs when R does not divide the tile count evenly.
__device__ __forceinline__ int run_span(int n_nblocks, int n_runs) {
  return (n_nblocks + n_runs - 1) / n_runs;
}

// K1's epilogue: the CTA's shared (bq, bins) histogram of one run is added
// into the global one (atomics: the runs of a query block meet there) and,
// when asked, stored whole into row (query, run) of the per-run slab.
__device__ __forceinline__ void flush_hist(const int* sh_hist, int* hist,
                                           int* run_hist, int qb, int run,
                                           int n_runs, int bq, int bins) {
  int* g = hist + static_cast<size_t>(qb) * bq * bins;
  for (int i = threadIdx.x; i < bq * bins; i += blockDim.x) {
    const int v = sh_hist[i];
    if (v) atomicAdd(g + i, v);
    if (run_hist) {
      const int qi = i / bins;
      run_hist[(static_cast<size_t>(qb * bq + qi) * n_runs + run) * bins +
               (i - qi * bins)] = v;
    }
  }
}

// Rows of tile j that are valid (global id < n_valid), in [0, bn].
__device__ __forceinline__ int valid_rows(int j, int bn, int n_valid) {
  const long long left = static_cast<long long>(n_valid) -
                         static_cast<long long>(j) * bn;
  return static_cast<int>(left < 0 ? 0 : (left < bn ? left : bn));
}

// K2's guard: tile t can hold no winner of its query block when it is
// disabled or its block-min exceeds the block's widest r* (uniform for the
// CTA).
__device__ __forceinline__ bool pruned_tile(const int* en, const int* bm,
                                            size_t t, int maxr) {
  return en[t] == 0 || bm[t] > maxr;
}

// K2's epilogue when the caller passed a counter: warp 0 counts the tiles
// of the CTA's run that the guard skipped, in registers, and adds them
// with one atomic. A null counter writes nothing.
__device__ __forceinline__ void add_pruned(unsigned long long* pruned,
                                           const int* en, const int* bm,
                                           int qb, int n_nblocks, int j0,
                                           int j1, int maxr) {
  if (pruned == nullptr || threadIdx.x >= 32) return;
  unsigned n = 0;
  for (int j = j0 + static_cast<int>(threadIdx.x); j < j1; j += 32)
    n += pruned_tile(en, bm, static_cast<size_t>(qb) * n_nblocks + j, maxr);
  n = __reduce_add_sync(0xffffffffu, n);
  if (threadIdx.x == 0 && n)
    atomicAdd(pruned, static_cast<unsigned long long>(n));
}

template <int W>
__global__ void hist_kernel(const int* __restrict__ q,
                            const int* __restrict__ x,
                            const int* __restrict__ en,
                            int* __restrict__ hist, int* __restrict__ bmin,
                            int* __restrict__ run_hist, int nw, int n_valid,
                            int bins, int bq, int bn, int n_nblocks,
                            int n_runs) {
  extern __shared__ int smem[];
  int* sh_hist = smem;              // bq * bins
  int* sh_min = smem + bq * bins;   // the current tile's block-min

  const int qb = blockIdx.y;
  const int run = blockIdx.x;
  const int j0 = run * run_span(n_nblocks, n_runs);
  const int j1 = min(j0 + run_span(n_nblocks, n_runs), n_nblocks);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int step = nthreads / bq;   // rows in flight per tile step
  const int qi = tid % bq;
  const int rs = tid / bq;

  for (int i = tid; i < bq * bins; i += nthreads) sh_hist[i] = 0;
  QRow<W> qrow;
  qrow.load(q + static_cast<size_t>(qb * bq + qi) * nw, nw);
  int* my_hist = sh_hist + qi * bins;
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const size_t t = static_cast<size_t>(qb) * n_nblocks + j;
    if (en[t] == 0) {               // uniform for the CTA
      if (tid == 0) bmin[t] = bins;
      continue;
    }
    if (tid == 0) *sh_min = bins;
    __syncthreads();
    const long long base = static_cast<long long>(j) * bn;
    const int rows = valid_rows(j, bn, n_valid);
    int local_min = bins;
    for (int r = rs; r < rows; r += step) {
      const int d = min(qrow.dist(x + (base + r) * nw, nw), bins - 1);
      atomicAdd(my_hist + d, 1);
      local_min = min(local_min, d);
    }
    if (local_min < bins) atomicMin(sh_min, local_min);
    __syncthreads();
    if (tid == 0) bmin[t] = *sh_min;
  }

  __syncthreads();
  flush_hist(sh_hist, hist, run_hist, qb, run, n_runs, bq, bins);
}

template <int W>
__global__ void emit_kernel(const int* __restrict__ q,
                            const int* __restrict__ x,
                            const int* __restrict__ en,
                            const int* __restrict__ bm,
                            const int* __restrict__ r_star,
                            const int* __restrict__ lt_base,
                            const int* __restrict__ tie_base,
                            int* __restrict__ out_d, int* __restrict__ out_i,
                            unsigned long long* __restrict__ pruned,
                            int nw, int n_valid, int id_base, int bins, int k,
                            int bq, int bn, int n_nblocks, int n_runs) {
  const unsigned full = 0xffffffffu;
  const int qb = blockIdx.y;
  const int run = blockIdx.x;
  const int j0 = run * run_span(n_nblocks, n_runs);
  const int j1 = min(j0 + run_span(n_nblocks, n_runs), n_nblocks);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  // the widest winning radius of the query block (every warp computes it)
  int maxr = INT_MIN;
  for (int i = lane; i < bq; i += 32) maxr = max(maxr, r_star[qb * bq + i]);
  maxr = __reduce_max_sync(full, maxr);

  for (int qi = warp; qi < bq; qi += nwarps) {
    const int row = qb * bq + qi;
    const int r = r_star[row];
    if (r < 0) continue;            // a padded query row emits nothing
    int cnt_lt = lt_base[static_cast<size_t>(row) * n_runs + run];
    int cnt_tie = tie_base[static_cast<size_t>(row) * n_runs + run];
    QRow<W> qrow;
    qrow.load(q + static_cast<size_t>(row) * nw, nw);
    int* od = out_d + static_cast<size_t>(row) * k;
    int* oi = out_i + static_cast<size_t>(row) * k;

    for (int j = j0; j < j1; ++j) {
      const size_t t = static_cast<size_t>(qb) * n_nblocks + j;
      if (pruned_tile(en, bm, t, maxr)) continue;  // uniform for the CTA
      const long long base = static_cast<long long>(j) * bn;
      const int rows = valid_rows(j, bn, n_valid);
      for (int r0 = 0; r0 < rows; r0 += 32) {     // uniform for the warp
        const int rr = r0 + lane;
        const bool ok = rr < rows;
        const int d = ok ? min(qrow.dist(x + (base + rr) * nw, nw), bins - 1)
                         : bins;
        const bool is_lt = ok && d < r;
        const bool is_tie = ok && d == r;
        const unsigned m_lt = __ballot_sync(full, is_lt);
        const unsigned m_tie = __ballot_sync(full, is_tie);
        int slot = -1;
        if (is_lt) {
          slot = cnt_lt + __popc(m_lt & below);
        } else if (is_tie) {
          slot = cnt_tie + __popc(m_tie & below);
        }
        if (slot >= 0 && slot < k) {
          od[slot] = d;
          oi[slot] = static_cast<int>(base + rr) + id_base;
        }
        cnt_lt += __popc(m_lt);
        cnt_tie += __popc(m_tie);
      }
    }
  }
  add_pruned(pruned, en, bm, qb, n_nblocks, j0, j1, maxr);
}

// ---------------------------------------------------------------------------
// d = 64, 128, 256 and 1024 (W = 2, 4, 8, 32) on the tensor cores
// ---------------------------------------------------------------------------

// The widest query block the tensor-core kernels take (MB <= 4 m16
// fragments; tc_max_bq lowers it to 32 at W = 32); wider blocks take the
// CUDA-core kernels.
constexpr int TC_MAX_BQ = 64;
constexpr int TC_THREADS = 256;
constexpr int TC_WARPS = TC_THREADS / 32;

// D += A.B with AND + popcount over 256 single-bit k: A 16 x 256 (rows g,
// g+8; k-slots of 32 bits t and 4+t), B 256 x 8 (column g), C 16 x 8.
__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A.B with AND + popcount over 128 single-bit k: A 16 x 128 (row g in
// a0, g+8 in a1; k-slot of 32 bits t), B 128 x 8 (column g, slot t), C as
// in mma_b1.
__device__ __forceinline__ void mma_b1_k128(int (&c)[4], unsigned a0,
                                            unsigned a1, unsigned b) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Lane (g, t)'s words 8t .. 8t+7 of a 32-word row (W = 32).
struct Chunk32 {
  int4 lo, hi;
};

// What load_chunk<W> returns: an int2 at W <= 8, a Chunk32 at W = 32.
template <int W>
struct ChunkOf {
  using type = int2;
};
template <>
struct ChunkOf<32> {
  using type = Chunk32;
};
template <int W>
using Chunk = typename ChunkOf<W>::type;

// Words 8t .. 8t+7 of the 32-word row at p (lane t = lane & 3), as two
// 16-byte loads: a quad of lanes reads the row's 128 contiguous bytes.
__device__ __forceinline__ Chunk32 load_row32(const int* p, int lane) {
  const int4* p4 = reinterpret_cast<const int4*>(p + 8 * (lane & 3));
  return Chunk32{__ldg(p4), __ldg(p4 + 1)};
}

// Lane (g, t)'s share of an n8 chunk of W-word data rows (zeros past
// `rows`), one load: at W = 32 words 8t .. 8t+7 of chunk row g, 32 bytes in
// two loads (a warp's load is the chunk's 1 KB, contiguous); at W = 8
// words 2t and 2t+1 of chunk row g, 8 bytes (the chunk's 256 contiguous
// bytes); at W = 4 word t in .x, 4 bytes (128 a warp), and .y = 0; at W = 2
// word t & 1 in .x (the chunk's 64 bytes, each word loaded by lanes t and
// t ^ 2), and .y = 0.
template <int W>
__device__ __forceinline__ Chunk<W> load_chunk(const int* xt, int c,
                                               int rows, int lane) {
  const int r = c * 8 + (lane >> 2);
  if constexpr (W == 32) {
    return r < rows ? load_row32(xt + static_cast<size_t>(r) * 32, lane)
                    : Chunk32{};
  } else if constexpr (W == 2) {
    return make_int2(
        r < rows ? __ldg(xt + static_cast<size_t>(r) * 2 + (lane & 1)) : 0, 0);
  } else if constexpr (W == 4) {
    return make_int2(
        r < rows ? __ldg(xt + static_cast<size_t>(r) * 4 + (lane & 3)) : 0, 0);
  } else {
    return r < rows ? __ldg(reinterpret_cast<const int2*>(
                          xt + static_cast<size_t>(r) * 8 + 2 * (lane & 3)))
                    : make_int2(0, 0);
  }
}

// One warp's distance tile: the query block's 16*MB rows (m16 fragments;
// lane (g, t) holds rows 16m+g and 16m+g+8, zeros past bq) against one n8
// chunk of W-word data rows (load_chunk<W>). dist() returns the Hamming
// distances in the accumulator layout: d[m][0], d[m][1] are chunk rows 2t,
// 2t+1 for query 16m+g; d[m][2], d[m][3] the same for query 16m+g+8.
//
// popc(q & ~x) + popc(~q & x) is the distance itself, on the packed words
// with no conversion. W = 8: word 2t of every code goes in k-slot t of lane
// t (k = 32t..32t+31) and word 2t+1 in slot 4+t, in A and B alike, so each
// bit of a query meets the same bit of the row; two products, a with ~x,
// then na = ~a with x. W = 4: lane t puts query word t in k-slot t and its
// complement in slot 4+t, and row word t's complement in B's slot t and the
// word itself in slot 4+t; one product. W = 2 (m16n8k128, k-slots 0-3 of
// lanes t = 0-3): lane t holds query word t & 1, complemented at t >= 2
// (q0, q1, ~q0, ~q1), in a[m][0] (row g) and a[m][1] (row g+8), and B is
// row word t & 1, complemented at t < 2 (~x0, ~x1, x0, x1); one product.
template <int MB, int W>
struct TcTile {
  static_assert(W == 2 || W == 4 || W == 8,
                "tensor-core rows are 64, 128 or 256 bits");
  unsigned a[MB][4], na[MB][4];     // na: W == 8 only
  unsigned nx;                      // W == 2 only: ~0 where B holds ~x

  __device__ __forceinline__ void load(const int* qblk, int bq, int lane) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * m + (lane >> 2) + 8 * h;
        if constexpr (W == 2) {
          const unsigned w =
              row < bq ? static_cast<unsigned>(__ldg(qblk + row * 2 +
                                                     (lane & 1)))
                       : 0u;
          a[m][h] = lane & 2 ? ~w : w;
        } else if constexpr (W == 4) {
          const unsigned w =
              row < bq ? static_cast<unsigned>(__ldg(qblk + row * 4 +
                                                     (lane & 3)))
                       : 0u;
          a[m][h] = w;
          a[m][2 + h] = ~w;
        } else {
          const int2 w = row < bq
                             ? __ldg(reinterpret_cast<const int2*>(
                                   qblk + row * 8 + 2 * (lane & 3)))
                             : make_int2(0, 0);
          a[m][h] = static_cast<unsigned>(w.x);
          a[m][2 + h] = static_cast<unsigned>(w.y);
          na[m][h] = ~a[m][h];
          na[m][2 + h] = ~a[m][2 + h];
        }
      }
    if constexpr (W == 2) nx = lane & 2 ? 0u : ~0u;
  }

  __device__ __forceinline__ void dist(int2 xw, int (&d)[MB][4]) const {
    const unsigned b0 = static_cast<unsigned>(xw.x);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0;
      if constexpr (W == 2) {
        mma_b1_k128(d[m], a[m][0], a[m][1], b0 ^ nx);
      } else if constexpr (W == 4) {
        mma_b1(d[m], a[m], ~b0, b0);
      } else {
        const unsigned b1 = static_cast<unsigned>(xw.y);
        mma_b1(d[m], a[m], ~b0, ~b1);
        mma_b1(d[m], na[m], b0, b1);
      }
    }
  }
};

// W = 32 (d = 1024): W = 8's pair of products on each 256-bit quarter of
// the code, eight m16n8k256 products into one accumulator a fragment. Lane
// t holds words 8t .. 8t+7 of each of its rows, in A (query rows 16m+g and
// 16m+g+8) and in B (load_chunk<32>) alike: in quarter i word 8t+2i goes in
// k-slot t and word 8t+2i+1 in slot 4+t, so each bit of a query meets the
// same bit of the row. a[m][i] is quarter i's A fragment; its complement is
// taken at the product.
template <int MB>
struct TcTile<MB, 32> {
  unsigned a[MB][4][4];

  __device__ __forceinline__ void load(const int* qblk, int bq, int lane) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * m + (lane >> 2) + 8 * h;
        const Chunk32 w = row < bq ? load_row32(qblk + row * 32, lane)
                                   : Chunk32{};
        const int words[8] = {w.lo.x, w.lo.y, w.lo.z, w.lo.w,
                              w.hi.x, w.hi.y, w.hi.z, w.hi.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[m][i][h] = static_cast<unsigned>(words[2 * i]);
          a[m][i][2 + h] = static_cast<unsigned>(words[2 * i + 1]);
        }
      }
  }

  __device__ __forceinline__ void dist(const Chunk32& xw,
                                       int (&d)[MB][4]) const {
    const unsigned x[8] = {
        static_cast<unsigned>(xw.lo.x), static_cast<unsigned>(xw.lo.y),
        static_cast<unsigned>(xw.lo.z), static_cast<unsigned>(xw.lo.w),
        static_cast<unsigned>(xw.hi.x), static_cast<unsigned>(xw.hi.y),
        static_cast<unsigned>(xw.hi.z), static_cast<unsigned>(xw.hi.w)};
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned(&ai)[4] = a[m][i];
        const unsigned na[4] = {~ai[0], ~ai[1], ~ai[2], ~ai[3]};
        mma_b1(d[m], ai, ~x[2 * i], ~x[2 * i + 1]);
        mma_b1(d[m], na, x[2 * i], x[2 * i + 1]);
      }
    }
  }
};

// K1 on the tensor cores: one CTA of 8 warps per (run, query block); warp
// w takes n8 chunks w, w+8, ... of each tile, prefetching its next chunk
// while the current one is scored, and adds each distance into the shared
// histogram of its query.
template <int MB, int W>
__global__ void __launch_bounds__(TC_THREADS)
    hist_tc_kernel(const int* __restrict__ q, const int* __restrict__ x,
                   const int* __restrict__ en, int* __restrict__ hist,
                   int* __restrict__ bmin, int* __restrict__ run_hist,
                   int n_valid, int bins, int bq, int bn, int n_nblocks,
                   int n_runs) {
  extern __shared__ int smem[];
  int* sh_hist = smem;              // bq * bins
  int* sh_min = smem + bq * bins;   // the current tile's block-min

  const int qb = blockIdx.y;
  const int run = blockIdx.x;
  const int j0 = run * run_span(n_nblocks, n_runs);
  const int j1 = min(j0 + run_span(n_nblocks, n_runs), n_nblocks);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t2 = 2 * (lane & 3);

  for (int i = threadIdx.x; i < bq * bins; i += TC_THREADS) sh_hist[i] = 0;
  TcTile<MB, W> tile;
  tile.load(q + static_cast<size_t>(qb) * bq * W, bq, lane);
  int* hrow[MB][2];                 // this lane's queries' histograms
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * m + (lane >> 2) + 8 * h;
      hrow[m][h] = row < bq ? sh_hist + row * bins : nullptr;
    }
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const size_t t = static_cast<size_t>(qb) * n_nblocks + j;
    if (en[t] == 0) {               // uniform for the CTA
      if (threadIdx.x == 0) bmin[t] = bins;
      continue;
    }
    if (threadIdx.x == 0) *sh_min = bins;
    __syncthreads();
    const int* xt = x + static_cast<size_t>(j) * bn * W;
    const int rows = valid_rows(j, bn, n_valid);
    const int chunks = (rows + 7) >> 3;
    int local_min = bins;
    Chunk<W> next = load_chunk<W>(xt, warp, rows, lane);
    for (int c = warp; c < chunks; c += TC_WARPS) {
      const Chunk<W> cur = next;
      next = load_chunk<W>(xt, c + TC_WARPS, rows, lane);
      int d[MB][4];
      tile.dist(cur, d);
      const bool ok0 = c * 8 + t2 < rows;
      const bool ok1 = c * 8 + t2 + 1 < rows;
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (hrow[m][h] == nullptr) continue;
          if (ok0) {
            const int v = min(d[m][2 * h], bins - 1);
            atomicAdd(hrow[m][h] + v, 1);
            local_min = min(local_min, v);
          }
          if (ok1) {
            const int v = min(d[m][2 * h + 1], bins - 1);
            atomicAdd(hrow[m][h] + v, 1);
            local_min = min(local_min, v);
          }
        }
    }
    local_min = __reduce_min_sync(0xffffffffu, local_min);
    if (lane == 0 && local_min < bins) atomicMin(sh_min, local_min);
    __syncthreads();
    if (threadIdx.x == 0) bmin[t] = *sh_min;
  }

  __syncthreads();
  flush_hist(sh_hist, hist, run_hist, qb, run, n_runs, bq, bins);
}

// K2's distance chunk: up to tc_ch(MB) data rows of a tile, one uint16 a
// (query, row) in static shared memory (33 KB at most); a row stride of
// tc_ch + 8 halfwords keeps a warp's paired stores on 32 banks.
__host__ __device__ constexpr int tc_ch(int mb) { return mb <= 2 ? 512 : 256; }

// K2 on the tensor cores: one CTA of 8 warps per (run, query block) walks
// its run's tiles in order, a tile in equal chunks of at most tc_ch rows
// (1032 rows: 3 of 344). Phase A: the warps score the chunk's n8 pieces
// into shared memory and keep each query's least distance in the chunk.
// Phase B: warp w takes queries w, w+8, ...; a query whose least distance
// exceeds its r* has no winner there and costs one shared load; the others
// are ranked in row order, 32 rows a step, with __ballot_sync +
// __popc(mask & lanemask) from the (query, run) counters, which start at
// lt_base / tie_base.
template <int MB, int W>
__global__ void __launch_bounds__(TC_THREADS)
    emit_tc_kernel(const int* __restrict__ q, const int* __restrict__ x,
                   const int* __restrict__ en, const int* __restrict__ bm,
                   const int* __restrict__ r_star,
                   const int* __restrict__ lt_base,
                   const int* __restrict__ tie_base, int* __restrict__ out_d,
                   int* __restrict__ out_i,
                   unsigned long long* __restrict__ pruned, int n_valid,
                   int id_base, int bins, int k, int bq, int bn,
                   int n_nblocks, int n_runs) {
  constexpr int QPW = 2 * MB;       // queries a warp ranks: 16 * MB / 8
  constexpr int CH = tc_ch(MB);
  constexpr int LD = CH + 8;
  constexpr int PCS = CH / 8 / TC_WARPS;  // n8 pieces a warp scores a chunk
  __shared__ unsigned short sdist[16 * MB * LD];
  __shared__ int sh_qmin[16 * MB];  // each query's least distance in the chunk
  const unsigned full = 0xffffffffu;
  const int qb = blockIdx.y;
  const int run = blockIdx.x;
  const int j0 = run * run_span(n_nblocks, n_runs);
  const int j1 = min(j0 + run_span(n_nblocks, n_runs), n_nblocks);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t2 = 2 * (lane & 3);
  const unsigned below = (1u << lane) - 1u;

  // the widest winning radius of the query block (every warp computes it)
  int maxr = INT_MIN;
  for (int i = lane; i < bq; i += 32) maxr = max(maxr, r_star[qb * bq + i]);
  maxr = __reduce_max_sync(full, maxr);

  int rq[QPW], cnt_lt[QPW], cnt_tie[QPW];
#pragma unroll
  for (int s = 0; s < QPW; ++s) {
    const int qi = warp + TC_WARPS * s;
    const size_t row = static_cast<size_t>(qb) * bq + qi;
    rq[s] = qi < bq ? r_star[row] : -1;   // r* < 0: emits nothing
    cnt_lt[s] = rq[s] >= 0 ? lt_base[row * n_runs + run] : 0;
    cnt_tie[s] = rq[s] >= 0 ? tie_base[row * n_runs + run] : 0;
  }
  TcTile<MB, W> tile;
  tile.load(q + static_cast<size_t>(qb) * bq * W, bq, lane);
  if (threadIdx.x < 16 * MB) sh_qmin[threadIdx.x] = bins;
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    const size_t t = static_cast<size_t>(qb) * n_nblocks + j;
    if (pruned_tile(en, bm, t, maxr)) continue;  // uniform for the CTA
    const long long base = static_cast<long long>(j) * bn;
    const int rows = valid_rows(j, bn, n_valid);
    const int n_ch = max(1, (rows + CH - 1) / CH);
    const int step = ((rows + n_ch - 1) / n_ch + 7) & ~7;
    for (int c0 = 0; c0 < rows; c0 += step) {   // uniform for the CTA
      const int crow = min(step, rows - c0);
      const int* xc = x + (base + c0) * W;
      int lmin[MB][2];
#pragma unroll
      for (int m = 0; m < MB; ++m) lmin[m][0] = lmin[m][1] = bins;
      Chunk<W> xs[PCS];             // all of the warp's pieces, in flight
#pragma unroll
      for (int p = 0; p < PCS; ++p)
        xs[p] = load_chunk<W>(xc, warp + p * TC_WARPS, crow, lane);
#pragma unroll
      for (int p = 0; p < PCS; ++p) {
        const int c = warp + p * TC_WARPS;
        if (c >= (crow + 7) >> 3) break;          // uniform for the warp
        int d[MB][4];
        tile.dist(xs[p], d);
        const bool ok0 = c * 8 + t2 < crow;
        const bool ok1 = c * 8 + t2 + 1 < crow;
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * m + (lane >> 2) + 8 * h;
            const int lo = min(d[m][2 * h], bins - 1);
            const int hi = min(d[m][2 * h + 1], bins - 1);
            *reinterpret_cast<unsigned*>(sdist + row * LD + c * 8 + t2) =
                static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
            lmin[m][h] = min(lmin[m][h], min(ok0 ? lo : bins, ok1 ? hi : bins));
          }
      }
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v = lmin[m][h];
          v = min(v, __shfl_xor_sync(full, v, 1));
          v = min(v, __shfl_xor_sync(full, v, 2));
          if (t2 == 0 && v < bins)
            atomicMin(sh_qmin + 16 * m + (lane >> 2) + 8 * h, v);
        }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < QPW; ++s) {
        const int r = rq[s];
        if (r < 0) continue;                      // uniform for the warp
        const int qi = warp + TC_WARPS * s;
        const int qmin = sh_qmin[qi];
        __syncwarp();
        if (lane == 0) sh_qmin[qi] = bins;        // ready for the next chunk
        if (qmin > r) continue;                   // no winner in the chunk
        const unsigned short* dq = sdist + qi * LD;
        const size_t row = static_cast<size_t>(qb) * bq + qi;
        for (int rr0 = 0; rr0 < crow; rr0 += 32) {
          const int rr = rr0 + lane;
          const int d = rr < crow ? dq[rr] : bins;
          const unsigned m_win = __ballot_sync(full, d <= r);
          if (m_win == 0) continue;               // uniform for the warp
          const unsigned m_lt = __ballot_sync(full, d < r);
          const unsigned m_tie = m_win & ~m_lt;
          int slot = -1;
          if (d < r) {
            slot = cnt_lt[s] + __popc(m_lt & below);
          } else if (d == r) {
            slot = cnt_tie[s] + __popc(m_tie & below);
          }
          if (slot >= 0 && slot < k) {
            out_d[row * k + slot] = d;
            out_i[row * k + slot] = static_cast<int>(base + c0 + rr) + id_base;
          }
          cnt_lt[s] += __popc(m_lt);
          cnt_tie[s] += __popc(m_tie);
        }
      }
      __syncthreads();
    }
  }
  add_pruned(pruned, en, bm, qb, n_nblocks, j0, j1, maxr);
}

template <int MB, int W>
int launch_hist_tc(const int* q, const int* x, const int* en, int* hist,
                   int* bmin, int* run_hist, int Q, int N, int n_valid,
                   int bins, int bq, int bn, int n_runs,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(bq) * bins + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_tc_kernel<MB, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hist_tc_kernel<MB, W>
      <<<dim3(n_runs, Q / bq), TC_THREADS, smem, stream>>>(
          q, x, en, hist, bmin, run_hist, n_valid, bins, bq, bn, N / bn,
          n_runs);
  return static_cast<int>(cudaGetLastError());
}

template <int MB, int W>
int launch_emit_tc(const int* q, const int* x, const int* en, const int* bm,
                   const int* r_star, const int* lt_base,
                   const int* tie_base, int* out_d, int* out_i,
                   unsigned long long* pruned, int Q, int N, int n_valid,
                   int id_base, int bins, int k, int bq, int bn, int n_runs,
                   cudaStream_t stream) {
  emit_tc_kernel<MB, W><<<dim3(n_runs, Q / bq), TC_THREADS, 0, stream>>>(
      q, x, en, bm, r_star, lt_base, tie_base, out_d, out_i, pruned,
      n_valid, id_base, bins, k, bq, bn, N / bn, n_runs);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_hist(const int* q, const int* x, const int* en, int* hist,
                int* bmin, int* run_hist, int Q, int N, int nw, int n_valid,
                int bins, int bq, int bn, int n_runs, cudaStream_t stream) {
  const int threads = bq * max(1, 256 / bq);
  const size_t smem = (static_cast<size_t>(bq) * bins + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hist_kernel<W><<<dim3(n_runs, Q / bq), threads, smem, stream>>>(
      q, x, en, hist, bmin, run_hist, nw, n_valid, bins, bq, bn, N / bn,
      n_runs);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_emit(const int* q, const int* x, const int* en, const int* bm,
                const int* r_star, const int* lt_base, const int* tie_base,
                int* out_d, int* out_i, unsigned long long* pruned, int Q,
                int N, int nw, int n_valid, int id_base, int bins, int k,
                int bq, int bn, int n_runs, cudaStream_t stream) {
  emit_kernel<W><<<dim3(n_runs, Q / bq), 32 * min(bq, 32), 0, stream>>>(
      q, x, en, bm, r_star, lt_base, tie_base, out_d, out_i, pruned, nw,
      n_valid, id_base, bins, k, bq, bn, N / bn, n_runs);
  return static_cast<int>(cudaGetLastError());
}

// Code widths with a tensor-core tile: 64, 128, 256 and 1024 bits.
constexpr bool tc_width(int nw) {
  return nw == 2 || nw == 4 || nw == 8 || nw == 32;
}

// The widest query block the tile takes at nw words: 32 at W = 32, whose
// MB = 4 instance would hold 64 registers of query fragments a thread, and
// is not built; TC_MAX_BQ at the other widths.
constexpr int tc_max_bq(int nw) { return nw == 32 ? 32 : TC_MAX_BQ; }

// The tensor-core instance for nw-word codes (tc_width) and a query block
// of bq <= tc_max_bq(nw) rows (MB = bq / 16 rounded up; 3 takes 4).
#define DISPATCH_TC(NW, BQ, CALL)             \
  do {                                        \
    const int mb_ = ((BQ) + 15) / 16;         \
    if ((NW) == 2) {                          \
      if (mb_ == 1) return CALL(1, 2);        \
      if (mb_ == 2) return CALL(2, 2);        \
      return CALL(4, 2);                      \
    }                                         \
    if ((NW) == 4) {                          \
      if (mb_ == 1) return CALL(1, 4);        \
      if (mb_ == 2) return CALL(2, 4);        \
      return CALL(4, 4);                      \
    }                                         \
    if ((NW) == 32) {                         \
      if (mb_ == 1) return CALL(1, 32);       \
      return CALL(2, 32);                     \
    }                                         \
    if (mb_ == 1) return CALL(1, 8);          \
    if (mb_ == 2) return CALL(2, 8);          \
    return CALL(4, 8);                        \
  } while (0)

}  // namespace

// Past the tensor-core dispatch (query blocks wider than tc_max_bq, and
// widths without a tile): d = 256 (8 words, the main path's width) gets the
// CUDA-core kernels with the query row in registers; every other width,
// d = 1024 at bq > 32 among them, takes the W == 0 ones.
#define DISPATCH_W(NW, CALL)            \
  switch (NW) {                         \
    case 8: return CALL(8);             \
    default: return CALL(0);            \
  }

extern "C" {

// The route K1 and K2 take for nw-word codes and a query block of bq rows:
// 1 the tensor-core kernels, 0 the CUDA-core ones. Both launchers dispatch
// by it, and the wrappers ask it which kernels a launch ran.
int topk_tc_route(int nw, int bq) {
  return tc_width(nw) && bq <= tc_max_bq(nw);
}

// K1. q (Q, nw), x (N, nw), en (Q/bq, N/bn) int32; hist (Q, bins) zeroed by
// the caller; bmin (Q/bq, N/bn) fully written here; run_hist (Q, n_runs,
// bins) fully written here, or null. One CTA per (run, query block).
int topk_hist_launch(const int* q, const int* x, const int* en, int* hist,
                     int* bmin, int* run_hist, int Q, int N, int nw,
                     int n_valid, int bins, int bq, int bn, int n_runs,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HIST_TC(MB, Wt)                                                \
  launch_hist_tc<MB, Wt>(q, x, en, hist, bmin, run_hist, Q, N, n_valid, \
                         bins, bq, bn, n_runs, s)
  if (topk_tc_route(nw, bq)) DISPATCH_TC(nw, bq, HIST_TC);
#undef HIST_TC
#define HIST_CALL(Wt) \
  launch_hist<Wt>(q, x, en, hist, bmin, run_hist, Q, N, nw, n_valid, bins, \
                  bq, bn, n_runs, s)
  DISPATCH_W(nw, HIST_CALL)
#undef HIST_CALL
}

// K2. r_star (Q,), lt_base and tie_base (Q, n_runs) int32: the first slot
// of each run's below-r* and tie winners; out_d, out_i (Q, k) zeroed by the
// caller; pruned, an int64 the tiles the guard skipped are added to, or
// null (then nothing is written there). One CTA per (run, query block).
int topk_emit_launch(const int* q, const int* x, const int* en,
                     const int* bm, const int* r_star, const int* lt_base,
                     const int* tie_base, int* out_d, int* out_i,
                     unsigned long long* pruned, int Q, int N, int nw,
                     int n_valid, int id_base, int bins, int k, int bq,
                     int bn, int n_runs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EMIT_TC(MB, Wt)                                                  \
  launch_emit_tc<MB, Wt>(q, x, en, bm, r_star, lt_base, tie_base, out_d, \
                         out_i, pruned, Q, N, n_valid, id_base, bins, k, \
                         bq, bn, n_runs, s)
  if (topk_tc_route(nw, bq)) DISPATCH_TC(nw, bq, EMIT_TC);
#undef EMIT_TC
#define EMIT_CALL(Wt) \
  launch_emit<Wt>(q, x, en, bm, r_star, lt_base, tie_base, out_d, out_i, \
                  pruned, Q, N, nw, n_valid, id_base, bins, k, bq, bn,   \
                  n_runs, s)
  DISPATCH_W(nw, EMIT_CALL)
#undef EMIT_CALL
}

}  // extern "C"
