// K4: causal GQA flash-attention forward on Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_fwd). It computes what the Pallas kernel computes, not
// its grid step by step: q upcast to f32 and THEN scaled by hd^-0.5;
// s = q . k in f32, set to NEG_INF = -1e30 where kpos > qpos; an online
// softmax (acc, m, l) in f32 whose probabilities are zeroed by the
// s > NEG_INF / 2 guard; query head h reads kv head h / G; out =
// acc / max(l, 1e-30), cast to the input type. Every real row sees key 0,
// so l > 0 on every row the caller keeps.
//
// Cost: a causal prefill does 2 * B * H * S^2 * hd FLOPs (QK^T and PV over
// half the S x S square) against q, k, v, o read or written once, so on
// this card the tensor cores (989 TFLOP/s bf16 dense) set the bound.
// This first kernel does not reach them: it runs every product as f32 FMAs
// on the CUDA cores, fed from shared memory, which is right for f32 and
// bf16 inputs alike and keeps the f32 arithmetic of the Pallas kernel.
// Moving QK^T and PV onto wgmma with TMA loads is later work.
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
// at the end. PV: lane c owns output columns c, c + 32, ... (hd / 32 of
// them per row, in registers); each key's probability is broadcast from
// its lane with a shuffle. q/k/v/o are read through their strides (last
// dim contiguous), so the (B, S, H, hd) layout of the model needs no copy.
// Any S works: rows >= S are not stored and keys >= S load as zeros, which
// the causal mask hides from every stored row.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// (or the error of cudaFuncSetAttribute) as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 32;               // query rows per CTA
constexpr int BK = 32;               // keys per step, one per lane
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;     // query rows per warp
constexpr float NEG_INF = -1e30f;    // the Pallas kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
  static_assert(HD % 32 == 0, "each lane owns hd / 32 output columns");
  constexpr int C = HD / 32;
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
      for (int c = 0; c < C; ++c) vv[c] = Vs[j * HD + lane + 32 * c];
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
    for (int c = 0; c < C; ++c) store_out(orow + lane + 32 * c, acc[r][c] / l);
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
    case 128: return launch<T, 128>(q, k, v, o, B, H, G, S, st, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, G, S, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, S, hd), k/v (B, KV, S, hd), o like q, all through element
// strides: st = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h,
// o_s}; the hd axis is contiguous. is_bf16: 1 for bfloat16, 0 for float32.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int S, int hd,
                           int is_bf16, const long long* st, float scale,
                           void* stream) {
  if (KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  return is_bf16
      ? dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, G, S, hd, st, scale, s)
      : dispatch_hd<float>(q, k, v, o, B, H, G, S, hd, st, scale, s);
}

}  // extern "C"
