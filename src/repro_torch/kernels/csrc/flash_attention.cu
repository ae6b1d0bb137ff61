// K4: causal GQA flash-attention forward on Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_fwd, its pl.pallas_call at :80). Both kernels below
// compute what the Pallas kernel computes, not its grid step by step: q
// upcast to f32 and scaled by hd^-0.5; s = q . k in f32, set to NEG_INF =
// -1e30 where kpos > qpos; an online softmax (acc, m, l) in f32 whose
// probabilities are zeroed by the s > NEG_INF / 2 guard; query head h
// reads kv head h / G; out = acc / max(l, 1e-30), cast to the input type.
// Every real row sees key 0, so m is finite after the first key tile
// (alpha = exp(NEG_INF - m) is then 0, not NaN) and l > 0 on every row
// the caller keeps.
//
// Bound: a causal prefill does 2 * B * H * S^2 * hd FLOPs (QK^T and PV
// over half the S x S square) against q, k, v and o read or written once.
// At the main shape (B=8, H=8, KV=1, S=2048, hd=256, bf16) that is 137.4
// GFLOP, 0.139 ms at the 989 TFLOP/s of the bf16 tensor cores (dense),
// against 0.045 ms for the 151 MB of HBM bytes: operations set the bound.
//
// == bfloat16: flash_fwd_tc_kernel<HD>, on the tensor cores ==
//
// Tiles. One CTA of 4 warps per (query block of BQ = 64 rows, head,
// batch); warp w owns the m16 strip of rows 16w .. 16w + 15. The CTA
// walks key tiles of BK = 32 from key 0 up to its last row. Two CTAs share
// an SM (__launch_bounds__(128, 2)), so one CTA's softmax and barriers
// overlap the other's products. The grid is one-dimensional with the query
// block slowest and issued longest first (block nq - 1 first): late blocks
// see the most keys, and the long ones would otherwise form a tail.
// The O accumulator takes 128 of the 255 registers a thread may hold at
// HD = 256, which sets the tile: 128 x 64 with 8 warps (one CTA per SM)
// spilled 100 bytes and was slower on the card, 128 x 32 did not spill
// and was slower still (PERF.md, PR 15, chip_k4_tiles.py).
//
// Shared memory. Q (BQ x HD bf16) and two stages each of K and V (BK x HD
// bf16), every row padded by 16 bytes (row stride HD + 8 elements). At
// HD = 256 a row is then 33 16-byte units (11 at 80, 15 at 112, 17 at
// 128: every one odd), so the 8 row addresses of an ldmatrix fall in 8
// different bank groups; an unpadded 512-byte stride would put all 8 in
// the same banks. Padding rather than an XOR swizzle:
// the addresses stay plain and the extra 3 KB fit. 99 KB per CTA at
// HD = 256, set with cudaFuncSetAttribute; two CTAs fit in the SM's 228 KB.
//
// Copies. cp.async.cg 16-byte copies: Q once with K/V tile 0, then K/V
// tile j + 1 into the other stage while tile j computes (commit_group,
// wait_group 1, a barrier; a second barrier before a stage is refilled).
// Rows at or past S are zero-filled (src-size 0); the causal mask hides
// them from every stored row. The wrapper hands only 16-byte aligned base
// pointers and strides.
//
// S = Q K^T. For each k16 slice of hd: ldmatrix.x4 loads the warp's Q
// fragment (the row-major A operand), ldmatrix.x4 without .trans two n8
// key tiles of K (K stored [key][hd] is exactly the "col" B operand), and
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 accumulates in f32.
// Nothing pairs k16 slices, so an odd count (5 at hd = 80, 7 at 112) needs
// no tail; PV pairs n8 tiles of hd, and hd / 8 is even for every hd that
// is a multiple of 16 (the head dims instantiated: 32, 64, 80, 112, 128,
// 256). The O accumulator is hd / 2 registers a thread (40 at hd = 80).
// Q is re-read from shared memory on every key tile rather than held in
// registers: at HD = 256 the O accumulator alone is 128 registers a
// thread. The f32 scores are scaled by hd^-0.5 after the product. At
// hd = 256 and 64 the scale is a power of two, so this equals the Pallas
// kernel's (q * scale) . k up to summation order; at hd = 32, 80, 112 and
// 128 it differs by one f32 rounding of each q element.
//
// Softmax. Only key tiles that cross a warp's diagonal compute the mask;
// a warp whose rows all lie before a tile's first key skips the tile (its
// p would be 0 and alpha 1). A thread holds rows g and g + 8 of its strip
// (g = lane / 4, the C fragment's layout); the row max reduces over the 4
// lanes of a row (__shfl_xor_sync over 1 and 2). m, l and alpha are f32
// per row; each lane sums its own p into a partial l, rescaled by the
// row's alpha, and the 4 partials are added at the end. l sums the f32 p.
//
// P as two bf16 halves. hi = bf16(p), lo = bf16(p - hi). The f32 C layout
// of two adjacent n8 score tiles is the A layout of one k16 bf16
// fragment, so both halves are packed straight from the score registers,
// with no trip through shared memory. PV is two mma.syncs per V fragment,
// hi . V + lo . V, with V loaded once by ldmatrix.x4.trans. p keeps about
// 2^-17 of relative error instead of bf16's 2^-9, which holds the output
// within 2 bf16 ulps of the f32 plain version. The lo product makes the
// kernel's own work 1.5x the function's (206.2 against 137.4 GFLOP at the
// main shape); the bound stays the function's.
//
// Epilogue. acc / max(l, 1e-30) as bf16 pairs through the output strides;
// rows at or past S are not stored.
//
// What still separates it from the bound: mma.sync (one warp, m16n8k16)
// instead of Hopper's wgmma (a warpgroup, 64-row tiles, B straight from
// shared memory); every warp re-reading the whole K and V tile through
// ldmatrix; cp.async issued by the computing warps instead of TMA and a
// producer warp (no warp specialisation); and the lo product.
//
// == float32: flash_fwd_kernel<float, HD>, on the CUDA cores ==
//
// Only the f32 model (the 2-layer check) takes it. Every product is an
// f32 FMA on the CUDA cores, fed from shared memory, which keeps the f32
// arithmetic of the Pallas kernel exactly.
//
// Design: one CTA per (query block of BQ = 32 rows, head, batch), 8 warps,
// warp w owning rows 4w .. 4w + 3 of the block. The block's scaled f32 q
// tile stays in shared memory; the CTA walks key steps of BK = 32 keys,
// only while the step starts below the block's last row (the causal skip
// of the Pallas kernel's pl.when, without its rectangular fetch). Each step
// stages the K and V rows as f32 in shared memory (K rows padded to hd + 1
// floats so lane j reading key j's row hits its own bank). Scores: lane j
// dots key j against the warp's four q rows (broadcast float4 reads). The
// row max is a warp shuffle reduction; each lane keeps a partial row sum
// l, scaled by the same alpha, and the lanes' partial sums are added once
// at the end. PV: lane c owns output columns c, c + 32, ... below hd
// (ceil(hd / 32) of them per row, in registers; at hd = 80 and 112 the
// last is owned by lanes below hd % 32 only); each key's probability is
// broadcast from its lane with a shuffle. q/k/v/o are read through their
// strides (last dim contiguous), so the (B, S, H, hd) layout of the model
// needs no copy.
// Any S works: rows >= S are not stored and keys >= S load as zeros, which
// the causal mask hides from every stored row.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// (or the error of cudaFuncSetAttribute) as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 32;               // query rows per CTA
constexpr int BK = 32;               // keys per step, one per lane
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;     // query rows per warp
constexpr float NEG_INF = -1e30f;    // the Pallas kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * HD + BK * (HD + 1) + BK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int G,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss, float scale) {
  static_assert(HD % 16 == 0, "float4 rows of q");
  constexpr int C = (HD + 31) / 32;  // lane c owns columns c, c + 32, ...
  constexpr bool EVEN = HD % 32 == 0;  // ... each of them below HD
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x HD, scaled f32
  float* Ks = Qs + BQ * HD;                      // BK x (HD + 1)
  float* Vs = Ks + BK * (HD + 1);                // BK x HD

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + kvh * ksh;
  const T* vp = v + b * vsb + kvh * vsh;

  for (int idx = tid; idx < BQ * HD; idx += WARPS * 32) {
    const int r = idx / HD, c = idx % HD, s = q0 + r;
    Qs[idx] = s < S ? to_f32(qp[s * qss + c]) * scale : 0.f;
  }

  float m[ROWS], lsum[ROWS], acc[ROWS][C];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    lsum[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int row0 = warp * ROWS;
  const int kend = min(q0 + BQ, S);       // keys a row of this block can see
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                      // the last step's reads are done
    for (int idx = tid; idx < BK * HD; idx += WARPS * 32) {
      const int r = idx / HD, c = idx % HD, s = k0 + r;
      const bool in = s < S;
      Ks[r * (HD + 1) + c] = in ? to_f32(kp[s * kss + c]) : 0.f;
      Vs[r * HD + c] = in ? to_f32(vp[s * vss + c]) : 0.f;
    }
    __syncthreads();

    // scores: lane j against key k0 + j
    float sc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r] = 0.f;
    const float* krow = Ks + lane * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k_0 = krow[d], k_1 = krow[d + 1], k_2 = krow[d + 2],
                  k_3 = krow[d + 3];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (row0 + r) * HD + d);
        sc[r] = fmaf(qv.x, k_0, sc[r]);
        sc[r] = fmaf(qv.y, k_1, sc[r]);
        sc[r] = fmaf(qv.z, k_2, sc[r]);
        sc[r] = fmaf(qv.w, k_3, sc[r]);
      }
    }

    // online softmax: the row max is warp-wide, the row sum stays per lane
    const int key = k0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + row0 + r;
      const float s = key <= qpos ? sc[r] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      p[r] = s > NEG_INF / 2 ? expf(s - m_new) : 0.f;
      lsum[r] = lsum[r] * alpha + p[r];
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
    }

    // PV: lane c accumulates columns c, c + 32, ...
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        vv[c] = EVEN || lane + 32 * c < HD ? Vs[j * HD + lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float l = fmaxf(warp_sum(lsum[r]), 1e-30f);
    const int s = q0 + row0 + r;
    if (s >= S) continue;
    T* orow = o + b * osb + h * osh + s * oss;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (EVEN || lane + 32 * c < HD)
        store_out(orow + lane + 32 * c, acc[r][c] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int G, int S, const long long* st, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, G, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int H, int G, int S, int hd, const long long* st, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, G, S, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;               // query rows per CTA, 16 per warp
constexpr int BK = 32;               // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;               // bf16 elements (16 bytes) per row
constexpr int MIN_CTAS = 2;          // CTAs resident on one SM

template <int HD>
constexpr size_t smem_bytes() {      // Q, then 2 stages of K, then of V
  return sizeof(bf16) * (BQ + 4 * BK) * (HD + PAD);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] holds its elements (lane / 4, 2 * (lane % 4) + {0, 1})
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the same, transposed: r[i] holds (2 * (lane % 4) + {0, 1}, lane / 4)
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, row) . b (16 x 8, col), bf16 operands
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, the first in the low half (fragment order)
__device__ __forceinline__ unsigned pack(bf16 x0, bf16 x1) {
  return static_cast<unsigned>(__bfloat16_as_ushort(x0)) |
         static_cast<unsigned>(__bfloat16_as_ushort(x1)) << 16;
}

// p0, p1 -> bf16 hi and lo halves with p = hi + lo to ~2^-17
__device__ __forceinline__ void split(float p0, float p1, unsigned& hi,
                                      unsigned& lo) {
  const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
            __float2bfloat16_rn(p1 - __bfloat162float(h1)));
}

// rows r0 .. r0 + ROWS - 1 of a (rows, HD) bf16 matrix with row stride rs
// into shared memory with row stride HD + PAD; rows >= S read as zeros
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long rs, int r0, int S,
                                          int tid) {
  constexpr int UNITS = HD / 8;      // 16-byte units per row
  constexpr int ALL = ROWS * UNITS;
#pragma unroll
  for (int it = 0; it < (ALL + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i / UNITS, c = i % UNITS;
    if (ALL % THREADS && i >= ALL) break;
    const int s = r0 + r;
    const bool in = s < S;
    cp_async16(smem_addr(dst + r * (HD + PAD) + c * 8),
               src + (in ? s * rs + c * 8 : 0), in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                    int H, int G, int BH, int nq,
                    long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss,
                    long long osb, long long osh, long long oss,
                    float scale) {
  static_assert(HD % 16 == 0, "k16 slices of hd");
  constexpr int LD = HD + PAD;       // shared row stride, elements
  constexpr int NO = HD / 8;         // n8 tiles of an output row
  constexpr int NS = BK / 8;         // n8 tiles of a score row
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + BQ * LD;           // stage st at Ks + st * BK * LD
  bf16* Vs = Ks + 2 * BK * LD;

  // longest first: the last query block is issued first
  const int qb = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int h = bh % H, b = bh / H, kvh = h / G;
  const int q0 = qb * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;     // the warp's first query position
  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + kvh * ksh;
  const bf16* vp = v + b * vsb + kvh * vsh;
  const int nk = (min(q0 + BQ, S) + BK - 1) / BK;

  load_rows<HD, BQ>(Qs, qp, qss, q0, S, tid);
  load_rows<HD, BK>(Ks, kp, kss, 0, S, tid);
  load_rows<HD, BK>(Vs, vp, vss, 0, S, tid);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // each lane's ldmatrix row address within a tile:
  // Q (A): rows lane % 16, columns 8 * (lane / 16) -> a0..a3
  const unsigned q_lane =
      smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  // K (B of two n8 key tiles): keys lane % 8 + 8 * (lane / 16), columns
  // 8 * (lane / 8 % 2) -> b0, b1 of the first tile, b0, b1 of the second
  const int k_lane =
      ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  // V (.trans, B of two n8 hd tiles): keys lane % 8 + 8 * (lane / 8 % 2),
  // columns 8 * (lane / 16) -> b0, b1 of the first tile, of the second
  const int v_lane =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1, k0 = j * BK;
    if (j + 1 < nk) {                // tile j + 1 into the other stage
      load_rows<HD, BK>(Ks + (st ^ 1) * BK * LD, kp, kss, k0 + BK, S, tid);
      load_rows<HD, BK>(Vs + (st ^ 1) * BK * LD, vp, vss, k0 + BK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();            // everything but tile j + 1 landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (k0 <= r0 + 15) {             // some row of the warp sees key k0
      const unsigned k_base = smem_addr(Ks + st * BK * LD + k_lane);
      const unsigned v_base = smem_addr(Vs + st * BK * LD + v_lane);

      // S = Q K^T in f32: s[n] is the C fragment of keys k0 + 8n ..
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, q_lane + kk * 32);
#pragma unroll
        for (int n = 0; n < NS / 2; ++n) {
          unsigned bk[4];
          ldsm_x4(bk, k_base + (n * 16 * LD + kk * 16) * 2);
          mma(s[2 * n], a, bk[0], bk[1]);
          mma(s[2 * n + 1], a, bk[2], bk[3]);
        }
      }

      // scale, mask (only where the tile crosses the warp's diagonal),
      // row max over the row's 4 lanes; element e of s[n] is row
      // r0 + g + 8 * (e / 2), key k0 + 8n + 2t + e % 2
      const bool diag = k0 + BK - 1 > r0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (diag && k0 + n * 8 + 2 * t + (e & 1) > r0 + g + (e >> 1) * 8)
            x = NEG_INF;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float p = x > NEG_INF / 2 ? expf(x - m[e >> 1]) : 0.f;
          s[n][e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V with P = hi + lo: score tiles 2kt, 2kt + 1 are the A
      // fragment of keys k0 + 16kt .. k0 + 16kt + 15
#pragma unroll
      for (int kt = 0; kt < NS / 2; ++kt) {
        unsigned hi[4], lo[4];
        split(s[2 * kt][0], s[2 * kt][1], hi[0], lo[0]);
        split(s[2 * kt][2], s[2 * kt][3], hi[1], lo[1]);
        split(s[2 * kt + 1][0], s[2 * kt + 1][1], hi[2], lo[2]);
        split(s[2 * kt + 1][2], s[2 * kt + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int n = 0; n < NO / 2; ++n) {
          unsigned bv[4];
          ldsm_x4_t(bv, v_base + (kt * 16 * LD + n * 16) * 2);
          mma(acc[2 * n], hi, bv[0], bv[1]);
          mma(acc[2 * n], lo, bv[0], bv[1]);
          mma(acc[2 * n + 1], hi, bv[2], bv[3]);
          mma(acc[2 * n + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                 // stage st is free to be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* op = o + b * osb + h * osh;
  const int s0 = r0 + g, s1 = s0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (s0 < S)
      *reinterpret_cast<unsigned*>(op + s0 * oss + c) =
          pack(__float2bfloat16_rn(acc[n][0] / l[0]),
               __float2bfloat16_rn(acc[n][1] / l[0]));
    if (s1 < S)
      *reinterpret_cast<unsigned*>(op + s1 * oss + c) =
          pack(__float2bfloat16_rn(acc[n][2] / l[1]),
               __float2bfloat16_rn(acc[n][3] / l[1]));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int G, int S, const long long* st, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_tc_kernel<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  const long long blocks = (long long)nq * H * B;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, G, H * B, nq,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale);
  return (int)cudaGetLastError();
}

int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int H, int G, int S, int hd, const long long* st, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 64: return launch<64>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 80: return launch<80>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 112: return launch<112>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 128: return launch<128>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 256: return launch<256>(q, k, v, o, B, H, G, S, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// q (B, H, S, hd), k/v (B, KV, S, hd), o like q, all through element
// strides: st = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h,
// o_s}; the hd axis is contiguous. is_bf16: 1 for bfloat16 (the tensor-core
// kernel; base pointers and strides 16-byte aligned), 0 for float32.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int S, int hd,
                           int is_bf16, const long long* st, float scale,
                           void* stream) {
  if (KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  return is_bf16
      ? tc::dispatch_hd(q, k, v, o, B, H, G, S, hd, st, scale, s)
      : dispatch_hd<float>(q, k, v, o, B, H, G, S, hd, st, scale, s);
}

}  // extern "C"
