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
// == bfloat16: flash_fwd_tc_kernel<HD>, on Hopper's wgmma ==
//
// Tiles. One CTA of WG = 2 warpgroups (256 threads) per (query block of
// BQ = 128 rows, head, batch); warpgroup w owns rows 64w .. 64w + 63, one
// wgmma M tile, and warp i of it the 16-row strip 16i .. 16i + 15. The CTA
// walks key tiles of BK = 64 from key 0 up to its last row; a warpgroup
// skips, as a whole, every tile wholly past its last row (wgmma is a
// warpgroup-collective instruction), and only tiles crossing a warp's
// diagonal compute the mask. The grid is one-dimensional with the query
// block slowest and issued longest first (block nq - 1 first): late blocks
// see the most keys, and the long ones would otherwise form a tail. A
// thread holds hd / 2 f32 of O (128 at hd = 256), BK / 2 scores and, a
// k16 slice at a time, 8 registers of P: hd = 256 runs one CTA an SM (223
// registers), hd <= 128 two (128 registers, no spills), whose barriers
// and softmax interleave (Tile<HD>; chip_k4_tiles.py times the
// alternatives).
//
// Shared memory in wgmma's canonical layouts. Q (BQ x hd), then STAGES = 2
// stages each of K and of V (BK x hd), all bf16, each tile stored as hd /
// PW panels of PW columns (PW = 64 where hd is a multiple of 64, 32 at hd
// = 32, 16 at hd = 80 and 112: 160- and 224-byte rows are multiples of 32
// bytes only). A panel's rows are 2 * PW bytes apart, and the 16-byte chunk
// index of a row is XORed with the row's offset bits 7 and up: the 128-,
// 64- or 32-byte swizzle, which a descriptor names and under which the 8
// rows of a core matrix fall in 8 different bank groups. Padded rows, as
// the mma.sync kernel had, no descriptor can describe. Q and K are K-major
// operands (hd contiguous, the products' depth); V, stored the same way,
// is the MN-major B operand of P V (the transpose bit), so no copy is ever
// transposed. The buffer starts on a 1024-byte boundary (the 128-byte
// swizzle's atom): 193 KiB at hd = 256, 97 KiB at 128, set with
// cudaFuncSetAttribute. 32-byte panels at every hd were 8-20 % slower at
// hd 128 and 256 (chip_k4_tiles.py).
//
// Copies. cp.async.cg 16-byte copies by all threads into the swizzled
// addresses, each thread at the same offset within every pass of rows:
// Q once with K/V tile 0, then at tile j, once every thread has waited for
// its copies of tile j (wait_group), fenced them for wgmma's reads
// (fence.proxy.async) and passed the one barrier of the tile, tile j + 1
// into the stage tile j - 1 left. Rows at or past S are zero-filled
// (src-size 0); the causal mask hides them from every stored row. The
// wrapper hands only 16-byte aligned base pointers and strides.
//
// S = Q K^T: hd / 16 wgmma.mma_async m64n64k16 (5 at hd = 80, 7 at 112),
// A and B both from shared-memory descriptors, then commit_group and
// wait_group 0. A warp's slice of the f32 accumulator is mma.sync's C
// fragment: rows g and g + 8 of its strip, columns 2t and 2t + 1 of each n8
// tile. The scores are scaled by hd^-0.5 after the product. At hd = 256
// and 64 the scale is a power of two, so this equals the Pallas kernel's
// (q * scale) . k up to summation order; at hd = 32, 80, 112 and 128 it
// differs by one f32 rounding of each q element.
//
// Softmax on that fragment: the row max reduces over the 4 lanes of a row
// (__shfl_xor_sync over 1 and 2); m, l and alpha are f32 per row; each
// lane sums its own p into a partial l, rescaled by the row's alpha, and
// the 4 partials are added at the end. p = exp(s - m) is computed as
// 2^((s - m) log2 e) on the special-function unit (ex2.approx, 2 ulps),
// which took a quarter of the kernel's time as expf. O is rescaled by
// alpha once wait_group has handed the accumulator back to ordinary code,
// and not at all where no row max of the warp moved (alpha is then exactly
// 1).
//
// P as two bf16 halves, in registers. hi = bf16(p), lo = bf16(p - hi), a
// pair of columns at a time (cvt.rn.bf16x2.f32). The f32 C layout of two
// adjacent n8 score tiles is the A layout of one k16 bf16 fragment, which
// is also wgmma's register A operand, so both halves are packed straight
// from the score registers. O += P V is two wgmma m64n{hd}k16 a k16 slice
// of keys, hi . V and lo . V, with V's descriptor as B. p keeps about 2^-17
// of relative error instead of bf16's 2^-9, which holds the output within
// 2 bf16 ulps of the f32 plain version. The lo product makes the kernel's
// own work 1.5x the function's (206.2 against 137.4 GFLOP at the main
// shape); the bound stays the function's.
//
// The warpgroup index comes through __shfl_sync, which tells ptxas it is
// uniform over the warp: without it ptxas serializes the wgmma of a
// branch that depends on it (C7520), and the kernel ran 8 % slower.
//
// Epilogue. acc / max(l, 1e-30) as bf16 pairs through the output strides;
// rows at or past S are not stored.
//
// What still separates it from the bound (chip_k4_tiles.py --ablations):
// the CTA's two warpgroups pass one barrier a tile, so both multiply, then
// both take the softmax, then both multiply again, and only at hd <= 128
// does the other CTA fill the gap (the barrier alone costs ~5 %); each
// warpgroup waits for its Q K^T before the softmax and for its P V before
// the next tile; the copies are issued by the computing threads (~5-10 %)
// instead of TMA and an mbarrier ring fed by a producer warp; and the lo
// product (~10-15 %).
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
// Plain C entry points, loaded with ctypes. The launch returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute) as an int.

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
constexpr float LOG2E = 1.4426950408889634f;
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

constexpr int WG = 2;                // warpgroups of a CTA, 64 query rows each
constexpr int BQ = 64 * WG;          // query rows per CTA
constexpr int THREADS = 128 * WG;

template <int HD>
struct Tile {
  static constexpr int BK = 64;      // keys per tile
  static constexpr int STAGES = 2;   // K/V tiles in shared memory
  // panel width in elements: the widest swizzle atom whose rows divide hd
  static constexpr int PW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int MIN_CTAS = HD <= 128 ? 2 : 1;  // resident on one SM
};

template <int HD>
constexpr size_t smem_bytes() {      // Q, K stages, V stages, 1 KB to align
  return sizeof(bf16) * (BQ + 2 * Tile<HD>::STAGES * Tile<HD>::BK) * HD +
         1024;
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

// the copies' shared-memory writes made visible to wgmma's operand reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that read and write it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Byte offset of 16-byte chunk c of row r within a panel. A tile is hd /
// PW panels of its rows x PW elements, one after another, each row PB = 2 *
// PW bytes; a chunk's index is XORed with bits 7 and up of its row's
// offset, as wgmma's 128-, 64- and 32-byte swizzle modes read it (panels of
// 64, 32 and 16 elements).
template <int HD>
__device__ __forceinline__ unsigned swizzled(int r, int c) {
  constexpr int PB = 2 * Tile<HD>::PW, CH = PB / 16;
  return r * PB + ((c ^ ((r * PB >> 7) & (CH - 1))) << 4);
}

// rows r0 .. r0 + ROWS - 1 of a (rows, HD) bf16 matrix with row stride rs
// into the panel layout at shared address dst; rows >= S read as zeros.
// Thread tid copies chunk tid % CH of rows tid / CH + RP i (RP = THREADS /
// CH rows a pass) in every panel: consecutive threads take the chunks of
// one panel row, then the next row, so the 8 chunks a quarter-warp writes
// land in 8 different bank groups. RP * PB is a multiple of 1024 bytes, so
// the swizzle term, and the thread's offset within a pass, is the same for
// all its rows.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(unsigned dst, const bf16* src,
                                          long long rs, int r0, int S,
                                          int tid) {
  constexpr int PW = Tile<HD>::PW, PB = 2 * PW, CH = PW / 8;
  constexpr int RP = THREADS / CH;
  const int c = tid % CH, rt = tid / CH;
  const unsigned d = dst + swizzled<HD>(rt, c);
#pragma unroll
  for (int rr = 0; rr < (ROWS + RP - 1) / RP; ++rr) {
    const int r = rt + rr * RP;
    if (ROWS % RP && r >= ROWS) break;
    const int s = r0 + r;
    const bool in = s < S;
    const bf16* row = src + (in ? s * rs : 0) + c * 8;
#pragma unroll
    for (int p = 0; p < HD / PW; ++p)
      cp_async16(d + (p * ROWS + rr * RP) * PB, row + p * PW, in ? 16 : 0);
  }
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode in bits 62-63 (1: 128
// bytes, 2: 64, 3: 32)
template <int HD>
__device__ __forceinline__ unsigned long long desc(unsigned addr,
                                                   unsigned lbo,
                                                   unsigned sbo) {
  constexpr unsigned long long MODE =
      Tile<HD>::PW == 64 ? 1 : Tile<HD>::PW == 32 ? 2 : 3;
  return static_cast<unsigned long long>((addr & 0x3ffff) >> 4) |
         static_cast<unsigned long long>(lbo >> 4) << 16 |
         static_cast<unsigned long long>(sbo >> 4) << 32 | MODE << 62;
}

// x0, x1 rounded to bf16 in one register, x0 in the low half (fragment
// order): one cvt.rn.bf16x2.f32
__device__ __forceinline__ unsigned pack(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const unsigned*>(&h);
}

// p0, p1 -> bf16 hi and lo halves with p = hi + lo to ~2^-17
__device__ __forceinline__ void split(float p0, float p1, unsigned& hi,
                                      unsigned& lo) {
  hi = pack(p0, p1);
  const float2 h = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack(p0 - h.x, p1 - h.y);
}

// 2^x on the special-function unit (ex2.approx: 2 ulps); tiny results
// flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma.mma_async m64nNk16, f32 += bf16 . bf16. The N / 2 accumulator
// registers of a thread are operands %0 .. %(N / 2 - 1), written out eight
// at a time; the operands after them are numbered at each instantiation.
#define K4_G0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define K4_G1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define K4_G2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define K4_G3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define K4_G4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define K4_G5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define K4_G6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define K4_G7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define K4_G8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define K4_G9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define K4_G10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define K4_G11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define K4_G12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define K4_G13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define K4_G14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define K4_G15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define K4_L16 K4_G0 ", " K4_G1
#define K4_L32 K4_L16 ", " K4_G2 ", " K4_G3
#define K4_L40 K4_L32 ", " K4_G4
#define K4_L56 K4_L40 ", " K4_G5 ", " K4_G6
#define K4_L64 K4_L56 ", " K4_G7
#define K4_L128 K4_L64 ", " K4_G8 ", " K4_G9 ", " K4_G10 ", " K4_G11 \
    ", " K4_G12 ", " K4_G13 ", " K4_G14 ", " K4_G15
#define K4_F8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])
#define K4_C16(d) K4_F8(d, 0), K4_F8(d, 8)
#define K4_C32(d) K4_C16(d), K4_F8(d, 16), K4_F8(d, 24)
#define K4_C40(d) K4_C32(d), K4_F8(d, 32)
#define K4_C56(d) K4_C40(d), K4_F8(d, 40), K4_F8(d, 48)
#define K4_C64(d) K4_C56(d), K4_F8(d, 56)
#define K4_C128(d) K4_C64(d), K4_F8(d, 64), K4_F8(d, 72), K4_F8(d, 80), \
    K4_F8(d, 88), K4_F8(d, 96), K4_F8(d, 104), K4_F8(d, 112), K4_F8(d, 120)

template <int N>
struct Wgmma;

// ss: a (64 x 16) and b (16 x N) from shared memory, both K-major; d = a .
// b, plus d where scale_d is not 0. rs: a from registers (each warp's 16
// rows in mma.sync's A fragment), b MN-major (the transpose bit); d += a . b
#define K4_WGMMA(N, LIST, OPS, R0, R1, R2, R3, R4, R5)                      \
  template <>                                                               \
  struct Wgmma<N> {                                                         \
    static __device__ __forceinline__ void ss(float (&d)[N / 2],            \
                                              unsigned long long da,        \
                                              unsigned long long db,        \
                                              int scale_d) {                \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #R2 ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "      \
          "{" LIST "}, %" #R0 ", %" #R1 ", p, 1, 1, 0, 0;\n}\n"             \
          : OPS(d) : "l"(da), "l"(db), "r"(scale_d) : "memory");            \
    }                                                                       \
    static __device__ __forceinline__ void rs(float (&d)[N / 2],            \
                                              const unsigned (&a)[4],       \
                                              unsigned long long db) {      \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #R5 ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "      \
          "{" LIST "}, {%" #R0 ", %" #R1 ", %" #R2 ", %" #R3 "}, %" #R4     \
          ", p, 1, 1, 1;\n}\n"                                              \
          : OPS(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
            "r"(1) : "memory");                                             \
    }                                                                       \
  };

K4_WGMMA(32, K4_L16, K4_C16, 16, 17, 18, 19, 20, 21)
K4_WGMMA(64, K4_L32, K4_C32, 32, 33, 34, 35, 36, 37)
K4_WGMMA(80, K4_L40, K4_C40, 40, 41, 42, 43, 44, 45)
K4_WGMMA(112, K4_L56, K4_C56, 56, 57, 58, 59, 60, 61)
K4_WGMMA(128, K4_L64, K4_C64, 64, 65, 66, 67, 68, 69)
K4_WGMMA(256, K4_L128, K4_C128, 128, 129, 130, 131, 132, 133)

template <int HD>
__global__ void __launch_bounds__(THREADS, Tile<HD>::MIN_CTAS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                    int H, int G, int BH, int nq,
                    long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss,
                    long long osb, long long osh, long long oss,
                    float scale) {
  static_assert(HD % 16 == 0, "k16 slices of hd");
  constexpr int BK = Tile<HD>::BK, STAGES = Tile<HD>::STAGES;
  constexpr int PW = Tile<HD>::PW, PB = 2 * PW;
  static_assert(HD % PW == 0 && BK % 16 == 0, "whole panels and k16 slices");
  constexpr int NO = HD / 2;         // O accumulator floats a thread
  constexpr int NS = BK / 2;         // score floats a thread
  constexpr int KT = BK / 16;        // k16 slices of a key tile
  constexpr unsigned TILE = BK * HD * sizeof(bf16);
  extern __shared__ uint4 smem_tc[];
  // Q, then the K stages, then the V stages, from a 1024-byte boundary
  // (the 128-byte swizzle's atom: 8 rows of 128 bytes)
  const unsigned Qs = (smem_addr(smem_tc) + 1023) & ~1023u;
  const unsigned Ks = Qs + BQ * HD * sizeof(bf16);
  const unsigned Vs = Ks + STAGES * TILE;

  // longest first: the last query block is issued first
  const int qb = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int h = bh % H, b = bh / H, kvh = h / G;
  const int q0 = qb * BQ;
  // wg through a shuffle: ptxas then knows it is uniform over the warp
  const int tid = threadIdx.x, wg = __shfl_sync(FULL, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 64 * wg;       // the warpgroup's first query position
  const int r0 = w0 + 16 * warp;     // the warp's
  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + kvh * ksh;
  const bf16* vp = v + b * vsb + kvh * vsh;
  const int nk = (min(q0 + BQ, S) + BK - 1) / BK;
  // the key tiles the warpgroup computes: those holding a key <= w0 + 63
  const int wk = w0 < S ? min(nk, (w0 + 64 + BK - 1) / BK) : 0;

  load_tile<HD, BQ>(Qs, qp, qss, q0, S, tid);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nk) {
      load_tile<HD, BK>(Ks + j * TILE, kp, kss, j * BK, S, tid);
      load_tile<HD, BK>(Vs + j * TILE, vp, vss, j * BK, S, tid);
    }
    cp_async_commit();               // one group per tile, empty or not
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // the warpgroup's 64 rows of Q; each panel holds BQ rows
  const unsigned qa = Qs + 64 * wg * PB;

  for (int j = 0; j < nk; ++j) {
    const int st = j % STAGES, k0 = j * BK;
    cp_async_wait<STAGES - 2>();     // tile j (and Q) landed
    fence_proxy_async();
    __syncthreads();                 // for every thread; all are done with
    const int jn = j + STAGES - 1;   // tile j - 1, whose stage jn takes
    if (jn < nk) {
      load_tile<HD, BK>(Ks + jn % STAGES * TILE, kp, kss, jn * BK, S, tid);
      load_tile<HD, BK>(Vs + jn % STAGES * TILE, vp, vss, jn * BK, S, tid);
    }
    cp_async_commit();

    if (j < wk) {                    // uniform over the warpgroup
      const unsigned ka = Ks + st * TILE, va = Vs + st * TILE;

      // S = Q K^T in f32. Q and K are K-major: slice kk of hd lies in
      // panel 16kk / PW at byte 32kk % PB of each row. Element 4n + e of
      // s is row r0 + g + 8 (e / 2), key k0 + 8n + 2t + e % 2.
      float s[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const unsigned p = kk * 16 / PW, col = kk * 16 % PW * 2;
        Wgmma<BK>::ss(s, desc<HD>(qa + p * BQ * PB + col, 16, 8 * PB),
                      desc<HD>(ka + p * BK * PB + col, 16, 8 * PB), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // scale, mask (only where the tile crosses the warp's diagonal),
      // row max over the row's 4 lanes
      const bool diag = k0 + BK - 1 > r0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int n = i >> 2, e = i & 3;
        float x = s[i] * scale;
        if (diag && k0 + n * 8 + 2 * t + (e & 1) > r0 + g + (e >> 1) * 8)
          x = NEG_INF;
        s[i] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float x = s[i];
        const float p =
            x > NEG_INF / 2 ? ex2((x - m[(i >> 1) & 1]) * LOG2E) : 0.f;
        s[i] = p;
        ls[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
      // alpha is exactly 1 on a row whose max did not move: the warp skips
      // the rescale when that holds for all its rows
      if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }

      // O += P V, one k16 slice of keys at a time: score tiles 2kt and
      // 2kt + 1 are the register A fragment of keys k0 + 16kt .. + 15,
      // packed as P = hi + lo. V is MN-major (hd contiguous): slice kt is
      // rows 16kt .. of every panel, the panels BK * PB bytes apart.
      fence_regs(acc);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        unsigned hi[4], lo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split(s[8 * kt + 2 * f], s[8 * kt + 2 * f + 1], hi[f], lo[f]);
        const unsigned long long dv =
            desc<HD>(va + kt * 16 * PB, BK * PB, 8 * PB);
        wgmma_fence();               // hi and lo written by ordinary code
        Wgmma<HD>::rs(acc, hi, dv);
        Wgmma<HD>::rs(acc, lo, dv);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    }
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
  for (int n = 0; n < NO / 4; ++n) {
    const int c = n * 8 + 2 * t;
    if (s0 < S)
      *reinterpret_cast<unsigned*>(op + s0 * oss + c) =
          pack(acc[4 * n] / l[0], acc[4 * n + 1] / l[0]);
    if (s1 < S)
      *reinterpret_cast<unsigned*>(op + s1 * oss + c) =
          pack(acc[4 * n + 2] / l[1], acc[4 * n + 3] / l[1]);
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

// the tile of hd's kernel: {query rows, keys, warpgroups, stages, panel
// width} of a CTA; 0 for an hd it does not take
template <int HD>
int tile_of(int* out) {
  using T = Tile<HD>;
  const int v[5] = {BQ, T::BK, WG, T::STAGES, T::PW};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

int tile_hd(int hd, int* out) {
  switch (hd) {
    case 32: return tile_of<32>(out);
    case 64: return tile_of<64>(out);
    case 80: return tile_of<80>(out);
    case 112: return tile_of<112>(out);
    case 128: return tile_of<128>(out);
    case 256: return tile_of<256>(out);
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

// the bf16 kernel's tile at head dim hd: out = {query rows, keys,
// warpgroups, K/V stages, panel width} of a CTA; returns 0, or an error
// for an hd it does not take
int flash_attention_tile(int hd, int* out) { return tc::tile_hd(hd, out); }

}  // extern "C"
