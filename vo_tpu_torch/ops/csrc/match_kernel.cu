// Fused descriptor matcher for fp32 operands on Hopper's CUDA cores (sm_90a):
// similarities as register-blocked fp32 FMAs fed by a TMA ring, row top-2 and column
// argmax in the epilogue, and the merge across blocks done by the blocks that finish
// last. One launch per call; plain C interface loaded through ctypes
// (vo_tpu_torch/ops/match.py builds it with nvcc at first use). bf16 operands take the
// tensor-core kernel in match_wgmma.cu instead.
//
// Replaces the TPU kernel vo_tpu/ops/pallas_match.py::_match_kernel (pallas_call in
// top2_mutual_pallas) in its float mode (SIFT-style gradhist and R2D2 descriptors).
// Same outputs and tie rules:
//   nn12[i]   = argmax_j S[i, j]         (lowest j among equal values)
//   top2[i]   = [S[i, nn12[i]], max_{j != nn12[i]} S[i, j]]  (a tied duplicate counts)
//   nn21[j]   = argmax_i S[i, j]         (lowest i among equal values)
// with S = A B^T accumulated in fp32 and invalid rows/columns set to -1e30.
//
// What bounds it on an H100: the products. They stay fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak): TF32 tensor cores keep ~3 decimal digits, beyond the 1e-5 that
// the float matchers are held to, and 3xTF32 would need S and S^T at three passes each
// for little gain over the FMA bound. At 2048 x 2048 x 128 that bound is 16 us against
// 0.6 us for the operand bytes, so the design is about keeping the FMA pipes fed:
//   * block = 256 threads (8 warps) over 128 rows of A and one split of B's columns in
//     128-column tiles. A thread owns an 8 x 8 micro-tile: rows ty + 16 i, columns
//     tx + 16 j (tx, ty < 16). No separate producer warp: with 9 warps one SM
//     sub-partition holds 3 of them and ptxas caps the kernel at 168 registers (it
//     spilled); 8 warps get up to 255;
//   * (A chunk, B chunk) pairs of 32 fp32 along K -- one 128-byte swizzle atom per
//     row -- stream through a 4-stage ring with TMA; an mbarrier per stage says when a
//     chunk has landed. The last warp to release a stage (a shared counter) refills it
//     with the chunk 4 ahead, so no thread waits to issue loads. TMA fills rows past
//     Na/Nb and K past D with zeros; D must be a multiple of 4 (the wrapper pads the
//     others with zero columns, which leaves every product as it was);
//   * the tiles stay row-major, so a thread reads float4s along K: per 4 k, 8 rows of
//     A and 8 of B in 16 loads of 16 bytes feed 256 FMAs. The 128B swizzle puts the
//     8 rows a quarter-warp reads in 8 different bank groups, and a warp covers 4
//     rows x 8 columns of threads, so each 16-byte load is one shared-memory wavefront;
//   * epilogue per tile: the row top-2 scans a thread's 8 columns per row in
//     increasing order (match_common.cuh: scan); the column argmax scans its 8 rows,
//     then the 4 row threads of a warp (shuffles), then the 4 warps of a column (one
//     shared-memory reduction of packed keys), and ends in one atomicMax per column
//     and block. At the end of the split the 16 column threads of a row merge
//     (shuffles, then shared memory) into the split's partial row;
//   * the last blocks merge the splits and decode the column keys
//     (match_common.cuh: merge_across_blocks), so the wrapper keeps that scratch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

using vo_match::col_key;
using vo_match::mbar_expect_tx;
using vo_match::mbar_wait;
using vo_match::NEG;
using vo_match::smem_u32;
using vo_match::tma_load;
using vo_match::Top2;

constexpr int BM = 128;                  // rows per block
constexpr int BN = 128;                  // columns per tile
constexpr int BK = 32;                   // K chunk: one 128-byte swizzle atom of fp32
constexpr int MT = 8;                    // micro-tile: MT x MT products per thread
constexpr int STAGES = 4;                // one tile's chunks at D = 128
constexpr int THREADS = 256;             // 16 x 16 threads of MT x MT
constexpr int A_BYTES = BM * BK * 4;     // 16 KiB
constexpr int B_BYTES = BN * BK * 4;     // 16 KiB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + slack to align to 1 KiB

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS, 1)
top2_simt_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const uint8_t* __restrict__ va, const uint8_t* __restrict__ vb, int na,
                 int nb, int k_chunks, int tiles_per_split, float* __restrict__ part_best,
                 float* __restrict__ part_sec, int* __restrict__ part_idx,
                 unsigned long long* __restrict__ colkey, unsigned int* __restrict__ tickets,
                 int* __restrict__ nn12, float* __restrict__ top2, int* __restrict__ nn21) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ unsigned int released[STAGES];  // warps done with the stage's chunk
  // Column keys of the 4 row groups of warps, double-buffered by tile parity.
  __shared__ unsigned long long red[2][4][BN];
  // The partial rows of the warps that hold the upper 64 columns of each tile.
  __shared__ float red_best[BM], red_sec[BM];
  __shared__ int red_idx[BM];

  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int col_begin = split * tiles_per_split * BN;
  const int col_end = min(nb, col_begin + tiles_per_split * BN);
  const int n_tiles = (col_end - col_begin + BN - 1) / BN;
  const unsigned long long key_init = col_key(NEG, 0);

  // Chunk j of the block's walk (tile j / k_chunks, K chunk j % k_chunks) goes to
  // stage j % STAGES.
  const int n_chunks = n_tiles * k_chunks;
  auto load_chunk = [&](int j) {
    const int s = j % STAGES;
    const int x = (j % k_chunks) * BK;
    const int col0 = col_begin + (j / k_chunks) * BN;
    uint8_t* dst = smem + s * STAGE_BYTES;
    mbar_expect_tx(&full_bar[s], STAGE_BYTES);
    tma_load(dst, &map_a, x, row0, &full_bar[s]);
    tma_load(dst + A_BYTES, &map_b, x, col0, &full_bar[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      vo_match::mbar_init(&full_bar[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(STAGES, n_chunks); ++j) load_chunk(j);
  }
  __syncthreads();

  {
    // Warp w covers rows ty = 4 (w / 2) + lane / 8 and columns tx = 8 (w % 2) + lane % 8
    // of the 16 x 16 thread grid.
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wy = warp / 2;
    const int tx = 8 * (warp % 2) + lane % 8;
    const int ty = 4 * wy + lane / 8;
    // Rows r = ty + 16 i all have r % 8 == ty % 8: one swizzle phase per thread.
    const int sa = ty & 7;
    const int sb = tx & 7;
    uint32_t rv = 0;  // bit i: row ty + 16 i is valid
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r < na && va[r] != 0) rv |= 1u << i;
    }
    Top2 st[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) st[i] = Top2{NEG, NEG, 0};

    float acc[MT][MT];
    int it = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int col0 = col_begin + t * BN;
      // Validity of the thread's 8 columns: loaded now, used after the products.
      uint8_t cvb[MT];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int col = col0 + tx + 16 * j;
        cvb[j] = col < col_end ? vb[col] : 0;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = 0.0f;

      for (int c = 0; c < k_chunks; ++c, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full_bar[s], (it / STAGES) & 1);
        const float* a_tile = reinterpret_cast<const float*>(smem + s * STAGE_BYTES) + ty * BK;
        const float* b_tile =
            reinterpret_cast<const float*>(smem + s * STAGE_BYTES + A_BYTES) + tx * BK;
#pragma unroll
        for (int q = 0; q < BK / 4; ++q) {  // 16-byte chunk q of each row: k = 4 q .. 4 q + 3
          float4 a[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            a[i] = *reinterpret_cast<const float4*>(a_tile + 16 * i * BK + ((q ^ sa) << 2));
          // One column's float4 at a time, then its 32 FMAs with the rows inner: the
          // FMAs into one accumulator are 8 apart, past the FMA latency, and only 8
          // registers of B are live. (With all 8 float4 of B loaded first, ptxas chained
          // each accumulator's 4 FMAs 2-3 instructions apart to free B's registers.)
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            const float4 b =
                *reinterpret_cast<const float4*>(b_tile + 16 * j * BK + ((q ^ sb) << 2));
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int i = 0; i < MT; ++i)
                acc[i][j] = fmaf(lane_of(a[i], e), lane_of(b, e), acc[i][j]);
          }
        }
        // Release the stage; the last warp refills it. Its reads are done (their
        // values have fed the FMAs); the fences order them, and the other warps'
        // counts, before the TMA write.
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(&released[s], 1u) == THREADS / 32 - 1) {
            released[s] = 0;
            __threadfence_block();
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            if (it + STAGES < n_chunks) load_chunk(it + STAGES);
          }
        }
      }

      // Epilogue of the tile.
      uint32_t cv = 0;  // bit j: column col0 + tx + 16 j is valid
#pragma unroll
      for (int j = 0; j < MT; ++j) cv |= (cvb[j] != 0 ? 1u : 0u) << j;
      unsigned long long* keys = red[t & 1][wy];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        // Row top-2 (columns in increasing order) and this column's argmax over the
        // thread's rows (in increasing order).
        float cb = NEG;
        int cr = 0;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float v = ((rv >> i) & (cv >> j) & 1u) ? acc[i][j] : NEG;
          vo_match::scan(st[i], v, col0 + tx + 16 * j);
          if (v > cb) {
            cb = v;
            cr = ty + 16 * i;
          }
        }
        // The warp's 4 row threads of this column (lanes 8 and 16 apart); the lower
        // row wins a tie.
#pragma unroll
        for (int off = 8; off < 32; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, cb, off);
          const int orow = __shfl_xor_sync(0xffffffffu, cr, off);
          if (ob > cb || (ob == cb && orow < cr)) {
            cb = ob;
            cr = orow;
          }
        }
        if (lane < 8) keys[tx + 16 * j] = col_key(cb, row0 + cr);
      }
      // The 4 warps of each column; then one atomic per column and block. The buffer
      // of the next tile is the other one, and no warp writes it again before every
      // warp has passed this barrier in the next tile.
      __syncthreads();
      if (tid < BN) {
        const int col = col0 + tid;
        unsigned long long k = red[t & 1][0][tid];
#pragma unroll
        for (int g = 1; g < 4; ++g) {
          const unsigned long long o = red[t & 1][g][tid];
          k = o > k ? o : k;
        }
        if (col < col_end && k > key_init) atomicMax(&colkey[col], k);
      }
    }

    // The 16 column threads of each row: 8 lanes of this warp (shuffles), then the
    // warp of the other 64 columns (shared memory); then this split's partial rows.
#pragma unroll
    for (int i = 0; i < MT; ++i) vo_match::merge_lanes(st[i], 1, 8);
    if (warp % 2 == 1 && lane % 8 == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = ty + 16 * i;
        red_best[r] = st[i].best;
        red_sec[r] = st[i].sec;
        red_idx[r] = st[i].idx;
      }
    }
    __syncthreads();
    if (warp % 2 == 0 && lane % 8 == 0) {
      const size_t base = static_cast<size_t>(split) * na;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = ty + 16 * i;
        vo_match::merge(st[i], red_best[r], red_sec[r], red_idx[r]);
        if (row0 + r < na) {
          part_best[base + row0 + r] = st[i].best;
          part_sec[base + row0 + r] = st[i].sec;
          part_idx[base + row0 + r] = st[i].idx;
        }
      }
    }
  }

  vo_match::merge_across_blocks<BM, THREADS>(row0, na, col_begin, col_end, part_best,
                                             part_sec, part_idx, colkey, tickets, nn12,
                                             top2, nn21);
}

}  // namespace

// Error codes: a cudaError_t, or those of vo_match::encode_operands.
extern "C" int vo_top2_mutual_simt(const float* A, const float* B, const uint8_t* va,
                                   const uint8_t* vb, int na, int nb, int d, int n_row_tiles,
                                   int splits, int tiles_per_split, float* part_best,
                                   float* part_sec, int* part_idx, unsigned long long* colkey,
                                   unsigned int* tickets, int* nn12, float* top2, int* nn21,
                                   void* stream) {
  CUtensorMap map_a, map_b;
  const int res = vo_match::encode_operands(&map_a, &map_b, A, B, na, nb, d,
                                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, BM);
  if (res != 0) return res;
  const cudaError_t err = cudaFuncSetAttribute(
      top2_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  top2_simt_kernel<<<dim3(n_row_tiles, splits), THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, va, vb, na, nb, (d + BK - 1) / BK, tiles_per_split, part_best, part_sec,
      part_idx, colkey, tickets, nn12, top2, nn21);
  return static_cast<int>(cudaGetLastError());
}
