// The fused two-pass counting select on Hopper (sm_90a): K1 pass-1
// histogram + block-min summary, K2 pass-2 in-order emit.
//
// K1 replaces src/repro/kernels/topk_select.py::_hist_kernel
// (hamming_hist_pallas); K2 replaces ::_emit_kernel (hamming_emit_pallas).
// Both compute what the Pallas kernels compute, on the same (bq, bn) tiles,
// so the histogram, the (Q/bq, N/bn) block-min summary and the emitted
// (dists, ids) slots are bit-identical to them and to the plain PyTorch
// versions in topk_select.py. `sub`, the TPU's VMEM sub-step, has no
// counterpart here.
//
// Cost: every (query, row) pair costs W 32-bit popcounts on the CUDA
// cores (16 per clock per SM), so at Q=4096, N=2^20, W=8 a pass is
// ~3.4e10 popcounts against ~0.03 GB of codes. That is not the card's
// fastest route: the same distances as a +-1 int8 plane product on the
// tensor cores cost 2*Q*N*d int8 operations, several times less time, so
// these kernels sit well above the card's bound (chip_smoke.py prints it).
// The design keeps every pair's cost at W xor + W popc + one shared-memory
// atomic (K1) or two warp ballots (K2), and reads the codes through L1/L2
// (32 MiB of codes fit in the 50 MB L2).
//
// K1: one CTA per (query block, run of N tiles). Thread t owns query
//     t % bq (its packed row in registers) and walks rows t / bq, +R, ...
//     of each tile; distances land in a bq x bins int32 shared histogram
//     with shared atomics (integer adds commute, so the result equals the
//     Pallas grid's sequential sum). Each tile's block-min is a CTA-wide
//     min written by one thread; the shared histogram is flushed to global
//     memory once per CTA with global atomics. A disabled tile writes
//     `bins` and adds nothing.
// K2: one CTA per query block walks its N tiles in order, because slot
//     order is global row order. Warp w owns queries w, w+nwarps, ...; the
//     below-r* and tie counts of its query stay in registers. Each 32-row
//     step ranks its winners with __ballot_sync + __popc(mask & lanemask).
//     A tile is skipped, uniformly for the CTA, when it is disabled or its
//     block-min exceeds the widest r* of the query block (padded query rows
//     carry r* = -1 and never raise it). Slots are written with plain
//     stores; untouched slots keep the zeros the wrapper allocated.
//
// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// (or the error of cudaFuncSetAttribute) as an int.

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

// Rows of tile j that are valid (global id < n_valid), in [0, bn].
__device__ __forceinline__ int valid_rows(int j, int bn, int n_valid) {
  const long long left = static_cast<long long>(n_valid) -
                         static_cast<long long>(j) * bn;
  return static_cast<int>(left < 0 ? 0 : (left < bn ? left : bn));
}

template <int W>
__global__ void hist_kernel(const int* __restrict__ q,
                            const int* __restrict__ x,
                            const int* __restrict__ en,
                            int* __restrict__ hist, int* __restrict__ bmin,
                            int nw, int n_valid, int bins, int bq, int bn,
                            int n_nblocks, int tiles_per_cta) {
  extern __shared__ int smem[];
  int* sh_hist = smem;              // bq * bins
  int* sh_min = smem + bq * bins;   // the current tile's block-min

  const int qb = blockIdx.y;
  const int j0 = blockIdx.x * tiles_per_cta;
  const int j1 = min(j0 + tiles_per_cta, n_nblocks);
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
  int* g = hist + static_cast<size_t>(qb) * bq * bins;
  for (int i = tid; i < bq * bins; i += nthreads) {
    const int v = sh_hist[i];
    if (v) atomicAdd(g + i, v);
  }
}

template <int W>
__global__ void emit_kernel(const int* __restrict__ q,
                            const int* __restrict__ x,
                            const int* __restrict__ en,
                            const int* __restrict__ bm,
                            const int* __restrict__ r_star,
                            const int* __restrict__ n_lt,
                            const int* __restrict__ slot_base,
                            int* __restrict__ out_d, int* __restrict__ out_i,
                            int nw, int n_valid, int id_base, int bins, int k,
                            int bq, int bn, int n_nblocks) {
  const unsigned full = 0xffffffffu;
  const int qb = blockIdx.x;
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
    const int nlt = n_lt[row];
    int cnt_lt = slot_base[row];
    int cnt_tie = 0;
    QRow<W> qrow;
    qrow.load(q + static_cast<size_t>(row) * nw, nw);
    int* od = out_d + static_cast<size_t>(row) * k;
    int* oi = out_i + static_cast<size_t>(row) * k;

    for (int j = 0; j < n_nblocks; ++j) {
      const size_t t = static_cast<size_t>(qb) * n_nblocks + j;
      if (en[t] == 0 || bm[t] > maxr) continue;   // uniform for the CTA
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
          slot = nlt + cnt_tie + __popc(m_tie & below);
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
}

template <int W>
int launch_hist(const int* q, const int* x, const int* en, int* hist,
                int* bmin, int Q, int N, int nw, int n_valid, int bins,
                int bq, int bn, int tiles_per_cta, int threads,
                cudaStream_t stream) {
  const int n_qblocks = Q / bq;
  const int n_nblocks = N / bn;
  const int n_split = (n_nblocks + tiles_per_cta - 1) / tiles_per_cta;
  const size_t smem = (static_cast<size_t>(bq) * bins + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hist_kernel<W><<<dim3(n_split, n_qblocks), threads, smem, stream>>>(
      q, x, en, hist, bmin, nw, n_valid, bins, bq, bn, n_nblocks,
      tiles_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_emit(const int* q, const int* x, const int* en, const int* bm,
                const int* r_star, const int* n_lt, const int* slot_base,
                int* out_d, int* out_i, int Q, int N, int nw, int n_valid,
                int id_base, int bins, int k, int bq, int bn, int threads,
                cudaStream_t stream) {
  emit_kernel<W><<<Q / bq, threads, 0, stream>>>(
      q, x, en, bm, r_star, n_lt, slot_base, out_d, out_i, nw, n_valid,
      id_base, bins, k, bq, bn, N / bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d = 256 (8 words, the main path's width) gets a kernel with the query row
// in registers; every other width takes the W == 0 kernel.
#define DISPATCH_W(NW, CALL)            \
  switch (NW) {                         \
    case 8: return CALL(8);             \
    default: return CALL(0);            \
  }

extern "C" {

// K1. q (Q, nw), x (N, nw), en (Q/bq, N/bn) int32; hist (Q, bins) zeroed by
// the caller; bmin (Q/bq, N/bn) fully written here. threads = bq * R.
int topk_hist_launch(const int* q, const int* x, const int* en, int* hist,
                     int* bmin, int Q, int N, int nw, int n_valid, int bins,
                     int bq, int bn, int tiles_per_cta, int threads,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HIST_CALL(Wt) \
  launch_hist<Wt>(q, x, en, hist, bmin, Q, N, nw, n_valid, bins, bq, bn, \
                  tiles_per_cta, threads, s)
  DISPATCH_W(nw, HIST_CALL)
#undef HIST_CALL
}

// K2. r_star, n_lt, slot_base (Q,) int32; out_d, out_i (Q, k) zeroed by the
// caller. threads = 32 * warps.
int topk_emit_launch(const int* q, const int* x, const int* en,
                     const int* bm, const int* r_star, const int* n_lt,
                     const int* slot_base, int* out_d, int* out_i, int Q,
                     int N, int nw, int n_valid, int id_base, int bins, int k,
                     int bq, int bn, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EMIT_CALL(Wt) \
  launch_emit<Wt>(q, x, en, bm, r_star, n_lt, slot_base, out_d, out_i, Q, \
                  N, nw, n_valid, id_base, bins, k, bq, bn, threads, s)
  DISPATCH_W(nw, EMIT_CALL)
#undef EMIT_CALL
}

}  // extern "C"
