// The materializing Hamming distance kernel on Hopper (sm_90a): K3.
//
// Replaces src/repro/kernels/hamming.py::_hamming_kernel
// (hamming_distance_pallas): (Q, W) x (N, W) packed codes -> the (Q, N)
// int32 matrix of XOR+popcount distances, one (bq, bn) output tile per
// CTA, as the Pallas grid has one per step. Codes are int32 words carrying
// uint32 bit patterns; every word is cast to unsigned before __popc, so a
// word with its top bit set counts all 32 of its bits.
//
// Cost: the output is the bound. At Q=4096, N=65536, W=8 it is 1 GiB of
// int32, 0.32 ms at 3.35 TB/s; the distances take 2.1e9 popcounts (0.51 ms
// at 16 per clock per SM) or a +-1 int8 plane product on the tensor cores
// (0.07 ms). The design keeps the output stores coalesced and every input
// read once per tile: the query tile's bq x W words are staged in shared
// memory (read back as broadcasts), each thread owns columns of the tile
// along N, holds its data row in registers (two 16-byte vector loads at
// W == 8), and walks the bq query rows, so a warp's 32 stores of one
// row are 128 contiguous bytes.
//
// Plain C entry point, loaded with ctypes; returns cudaGetLastError() as
// an int.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

// One data row's W words (W % 4 == 0), in registers, loaded as 16-byte
// vectors.
template <int W>
struct XRow {
  static_assert(W % 4 == 0, "XRow reads rows as 16-byte vectors");
  unsigned w[W];

  __device__ __forceinline__ void load(const int* __restrict__ x) {
    const int4* x4 = reinterpret_cast<const int4*>(x);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const int4 v = __ldg(x4 + i);
      w[4 * i] = static_cast<unsigned>(v.x);
      w[4 * i + 1] = static_cast<unsigned>(v.y);
      w[4 * i + 2] = static_cast<unsigned>(v.z);
      w[4 * i + 3] = static_cast<unsigned>(v.w);
    }
  }

  // distance to query row r of the staged tile (broadcast shared reads)
  __device__ __forceinline__ int dist(const unsigned* qs, int r) const {
    const uint4* q4 = reinterpret_cast<const uint4*>(qs + r * W);
    int d = 0;
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 v = q4[i];
      d += __popc(w[4 * i] ^ v.x);
      d += __popc(w[4 * i + 1] ^ v.y);
      d += __popc(w[4 * i + 2] ^ v.z);
      d += __popc(w[4 * i + 3] ^ v.w);
    }
    return d;
  }
};

// W == 8 (256-bit codes, every path's width): the row in registers.
// W == 0: any width, the row read through the read-only cache once per
// query row.
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
hamming_kernel(const int* __restrict__ q, const int* __restrict__ x,
               int* __restrict__ out, int N, int nw, int bq, int bn) {
  extern __shared__ __align__(16) unsigned qs[];        // bq x nw
  const long long q0 = static_cast<long long>(blockIdx.y) * bq;
  const long long n0 = static_cast<long long>(blockIdx.x) * bn;
  const int* qt = q + q0 * nw;
  for (int i = threadIdx.x; i < bq * nw; i += blockDim.x)
    qs[i] = static_cast<unsigned>(qt[i]);
  __syncthreads();

  for (int c = threadIdx.x; c < bn; c += blockDim.x) {
    const int* xr = x + (n0 + c) * nw;
    int* o = out + q0 * N + n0 + c;
    if constexpr (W > 0) {
      XRow<W> row;
      row.load(xr);
      for (int r = 0; r < bq; ++r)
        o[static_cast<long long>(r) * N] = row.dist(qs, r);
    } else {
      for (int r = 0; r < bq; ++r) {
        int d = 0;
        for (int i = 0; i < nw; ++i)
          d += __popc(static_cast<unsigned>(__ldg(xr + i)) ^ qs[r * nw + i]);
        o[static_cast<long long>(r) * N] = d;
      }
    }
  }
}

}  // namespace

// q: (Q, W), x: (N, W) int32, out: (Q, N) int32, all row-major and
// contiguous; Q % bq == 0, N % bn == 0, bq * W * 4 bytes of shared memory
// (at most 48 KB), rows 16-byte aligned when W == 8 (the wrapper
// checks all of it).
extern "C" int hamming_launch(const int* q, const int* x, int* out, int Q,
                              int N, int W, int bq, int bn, int threads,
                              cudaStream_t stream) {
  const dim3 grid(N / bn, Q / bq);
  const size_t smem = static_cast<size_t>(bq) * W * sizeof(unsigned);
#define K3_LAUNCH(NW)                                                  \
  hamming_kernel<NW><<<grid, threads, smem, stream>>>(q, x, out, N, W, \
                                                      bq, bn)
  if (W == 8)
    K3_LAUNCH(8);
  else
    K3_LAUNCH(0);
#undef K3_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
