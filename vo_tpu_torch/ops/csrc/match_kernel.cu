// Fused descriptor matcher for fp32 operands on the CUDA cores (sm_90a): similarity
// GEMM + row top-2 + column argmax in one pass, with a plain C interface loaded
// through ctypes (vo_tpu_torch/ops/match.py builds it with nvcc at first use).
// bf16 operands take the tensor-core kernel in match_wgmma.cu instead.
//
// Replaces the TPU kernel vo_tpu/ops/pallas_match.py::_match_kernel (pallas_call in
// top2_mutual_pallas) in its float mode (R2D2 / SIFT descriptors). Same outputs and
// tie rules:
//   nn12[i]   = argmax_j S[i, j]         (lowest j among equal values)
//   top2[i]   = [S[i, nn12[i]], max_{j != nn12[i]} S[i, j]]  (a tied duplicate counts)
//   nn21[j]   = argmax_i S[i, j]         (lowest i among equal values)
// with S = A B^T accumulated in fp32 and invalid rows/columns set to -1e30.
//
// What bounds it on an H100: the products are fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak). TF32 tensor cores would be faster but keep only ~3 decimal digits, beyond the
// 1e-5 that the float matchers are held to, so this kernel stays on the CUDA cores.
//
// Design. The TPU kernel kept the full B resident in VMEM and carried the column
// reduction in scratch across a sequential grid. CUDA blocks run concurrently, so:
//   * a block owns a 64-row tile of A and one contiguous split of B's columns, and
//     loops over that split in 64-column tiles staged through shared memory with the
//     D axis in 32-wide chunks (no cap on Nb: B is never resident as a whole);
//   * each thread keeps a running (best, idx, second) per row over its columns; the
//     16 threads of a row merge with warp shuffles, and the splits of a row merge in
//     the finalize kernel (match_common.cuh: scan, merge);
//   * the column argmax is an atomicMax on the packed key of match_common.cuh. Blocks
//     first reduce within shared memory, then do one global atomic per column. The
//     wrapper fills the keys with col_key(-1e30, 0) before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

using vo_match::col_key;
using vo_match::NEG;
using vo_match::Top2;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
top2_tile_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 const uint8_t* __restrict__ va, const uint8_t* __restrict__ vb,
                 int na, int nb, int d, int cols_per_split,
                 float* __restrict__ part_best, float* __restrict__ part_sec,
                 int* __restrict__ part_idx, unsigned long long* __restrict__ colkey) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  __shared__ unsigned long long ckey[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx + 16 j of each tile
  const int ty = tid / 16;  // row group: rows ty + 16 i of the block's tile
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int col_begin = split * cols_per_split;
  const int col_end = min(nb, col_begin + cols_per_split);

  bool rv[4];
  Top2 st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    rv[i] = r < na && va[r] != 0;
    st[i] = Top2{NEG, NEG, 0};
  }

  for (int col0 = col_begin; col0 < col_end; col0 += BN) {
    if (tid < BN) ckey[tid] = 0ull;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int it = 0; it < (BM * BK) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int r = e / BK;
        const int k = e % BK;
        const int gk = k0 + k;
        const int ga = row0 + r;
        const int gb = col0 + r;
        As[k][r] = (ga < na && gk < d) ? A[static_cast<size_t>(ga) * d + gk] : 0.0f;
        Bs[k][r] = (gb < col_end && gk < d) ? B[static_cast<size_t>(gb) * d + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= col_end) continue;
      const bool cv = vb[c] != 0;
      float cbest = NEG;
      int crow = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = (rv[i] && cv) ? acc[i][j] : NEG;
        vo_match::scan(st[i], v, c);
        if (v > cbest) {  // rows increase with i: first of equal values wins
          cbest = v;
          crow = row0 + ty + 16 * i;
        }
      }
      // (-1e30, any row) never beats the initial key (-1e30, row 0).
      if (cbest > NEG) atomicMax(&ckey[tx + 16 * j], col_key(cbest, crow));
    }
    __syncthreads();
    if (tid < BN && col0 + tid < col_end && ckey[tid] != 0ull)
      atomicMax(&colkey[col0 + tid], ckey[tid]);
  }

  // Merge the 16 column groups of each row (lanes tx = 0..15 of one half-warp).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, st[i].best, off);
      const float os = __shfl_xor_sync(0xffffffffu, st[i].sec, off);
      const int oi = __shfl_xor_sync(0xffffffffu, st[i].idx, off);
      vo_match::merge(st[i], ob, os, oi);
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < na) {
      const size_t o = static_cast<size_t>(split) * na + r;
      part_best[o] = st[i].best;
      part_sec[o] = st[i].sec;
      part_idx[o] = st[i].idx;
    }
  }
}

__global__ void finalize_kernel(int na, int nb, int splits,
                                const float* __restrict__ part_best,
                                const float* __restrict__ part_sec,
                                const int* __restrict__ part_idx,
                                const unsigned long long* __restrict__ colkey,
                                int* __restrict__ nn12, float* __restrict__ top2,
                                int* __restrict__ nn21) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < na) {
    Top2 s{part_best[i], part_sec[i], part_idx[i]};
    for (int p = 1; p < splits; ++p) {
      const size_t o = static_cast<size_t>(p) * na + i;
      vo_match::merge(s, part_best[o], part_sec[o], part_idx[o]);
    }
    nn12[i] = s.idx;
    top2[2 * i] = s.best;
    top2[2 * i + 1] = s.sec;
  }
  if (i < nb) nn21[i] = vo_match::col_key_row(colkey[i]);
}

}  // namespace

extern "C" int vo_top2_mutual_simt(const float* A, const float* B, const uint8_t* va,
                                   const uint8_t* vb, int na, int nb, int d, int splits,
                                   int cols_per_split, float* part_best, float* part_sec,
                                   int* part_idx, unsigned long long* colkey, int* nn12,
                                   float* top2, int* nn21, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((na + BM - 1) / BM, splits);
  top2_tile_kernel<<<grid, THREADS, 0, s>>>(A, B, va, vb, na, nb, d, cols_per_split,
                                            part_best, part_sec, part_idx, colkey);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = na > nb ? na : nb;
  finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(na, nb, splits, part_best, part_sec,
                                                  part_idx, colkey, nn12, top2, nn21);
  return static_cast<int>(cudaGetLastError());
}
