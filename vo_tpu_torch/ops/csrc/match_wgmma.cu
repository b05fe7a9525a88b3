// Fused descriptor matcher for bf16 operands on Hopper's tensor cores (sm_90a):
// similarities with wgmma.mma_async (m64n128k16, f32 += bf16 x bf16, both operands
// from shared memory), row top-2 and column argmax in the epilogue, and the merge
// across blocks done by the blocks that finish last. One launch per call; plain C
// interface loaded through ctypes (vo_tpu_torch/ops/match.py builds it with nvcc at
// first use).
//
// Replaces the TPU kernel vo_tpu/ops/pallas_match.py::_match_kernel (pallas_call in
// top2_mutual_pallas) for bf16 operands, the +-1 binary descriptors of the main path.
// Same outputs and tie rules as match_kernel.cu (see there). +-1 products are exact in
// bf16 and their sums (|s| <= D) exact in fp32, so the tensor cores lose nothing.
//
// What bounds it on an H100: at 2048 x 2048 x 256 the work is 2.1 GFLOP against 2 MiB
// of operands, so the bf16 tensor-core rate (989 TFLOP/s, ~2 us) is the bound. A call
// that short is dominated by what surrounds the products: the launch, the first loads,
// the epilogue's reductions and the merge across blocks. The design:
//   * block = two consumer warpgroups (64 rows each, 128 rows in all) + one producer
//     warp. The grid is (row tiles, column splits); each block walks its split of B's
//     columns in 128-column tiles (no cap on Nb);
//   * the producer streams (A chunk, B chunk) pairs of 64 bf16 along K -- one
//     128-byte swizzle atom each -- through a ring of STAGES stages with TMA
//     (cp.async.bulk.tensor.2d, CU_TENSOR_MAP_SWIZZLE_128B) and mbarriers. TMA fills
//     rows past Na/Nb and K past D with zeros, which handles the ragged edges; any D
//     that is a multiple of 8 works (the wrapper pads the others), with no cap;
//   * from each chunk a consumer warpgroup computes both S (its 64 rows x the tile's
//     128 columns) and S^T (64 of the tile's columns x the block's 128 rows): 4 + 4
//     wgmma k16 steps, each advancing the shared-memory descriptors by 32 bytes inside
//     the swizzle atom. The row top-2 then scans S and the column argmax scans S^T,
//     each along a thread's own registers and then a quad of lanes. Reducing columns
//     of S alone across the 8 lanes and 8 warps that share them cost more than the
//     second product does;
//   * the block that is last (atomic ticket) among a row tile's splits merges that
//     tile's partial rows and writes nn12 and top2; the last among a split's row tiles
//     writes nn21 for the split's columns from keys packed as in match_common.cuh.
//     Each resets the column keys and its ticket to their initial values, so the
//     wrapper keeps that scratch cached across calls.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

using vo_match::col_key;
using vo_match::mbar_arrive;
using vo_match::mbar_expect_tx;
using vo_match::mbar_wait;
using vo_match::NEG;
using vo_match::smem_u32;
using vo_match::tma_load;
using vo_match::Top2;

constexpr int BM = 128;                  // rows per block: two warpgroups of 64
constexpr int BN = 128;                  // columns per tile: wgmma m64n128
constexpr int BK = 64;                   // K chunk: one 128-byte swizzle atom of bf16
constexpr int STAGES = 4;                // one tile's chunks at D = 256
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int A_BYTES = BM * BK * 2;     // 16 KiB
constexpr int B_BYTES = BN * BK * 2;     // 16 KiB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + slack to align to 1 KiB

// wgmma shared-memory descriptor of a K-major tile in the 128B-swizzled layout that
// TMA writes: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused (1),
// layout type 1 (128B swizzle), base offset 0 (stage bases are 1 KiB aligned).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the wgmma fences.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32 fragment) += A (64 x 16) * B (128 x 16)^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
top2_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const uint8_t* __restrict__ va, const uint8_t* __restrict__ vb, int na,
                  int nb, int k_chunks, int tiles_per_split, float* __restrict__ part_best,
                  float* __restrict__ part_sec, int* __restrict__ part_idx,
                  unsigned long long* __restrict__ colkey, unsigned int* __restrict__ tickets,
                  int* __restrict__ nn12, float* __restrict__ top2, int* __restrict__ nn21) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];

  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int col_begin = split * tiles_per_split * BN;
  const int col_end = min(nb, col_begin + tiles_per_split * BN);
  const int n_tiles = (col_end - col_begin + BN - 1) / BN;
  const unsigned long long key_init = col_key(NEG, 0);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      vo_match::mbar_init(&full_bar[s], 1);
      vo_match::mbar_init(&empty_bar[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer: one thread keeps the ring full.
    if (tid == CONSUMERS) {
      int it = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int col0 = col_begin + t * BN;
        for (int c = 0; c < k_chunks; ++c, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty_bar[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* dst = smem + s * STAGE_BYTES;
          mbar_expect_tx(&full_bar[s], STAGE_BYTES);
          tma_load(dst, &map_a, c * BK, row0, &full_bar[s]);
          tma_load(dst + A_BYTES, &map_b, c * BK, col0, &full_bar[s]);
        }
      }
    }
  } else {
    // Consumers. Accumulator fragment of m64nN: register i of lane l in warp w of a
    // warpgroup holds row 16 w + l/4 + 8 ((i/2) % 2), column 8 (i/4) + 2 (l%4) + i%2.
    // From the same shared tiles, warpgroup g computes per tile
    //   acc_s = S[rows 64 g .. 64 g + 63 of the block, the tile's 128 columns] and
    //   acc_t = S^T[columns 64 g .. 64 g + 63 of the tile, the block's 128 rows].
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int q = lane % 4;
    const int frag_row = 64 * wg + 16 * warp + lane / 4;  // fragment rows frag_row, +8
    const int r0 = row0 + frag_row;
    const int r1 = r0 + 8;
    const bool rv0 = r0 < na && va[r0] != 0;
    const bool rv1 = r1 < na && va[r1] != 0;
    // Validity of the block's rows as acc_t's columns: bit b of word k is row
    // row0 + 32 k + b, shifted by 2 q so that bit 8 (j % 4) + e is fragment column
    // 8 j + 2 q + e (j < 16, e < 2) in word j / 4.
    uint32_t rbits[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = row0 + 32 * k + lane;
      rbits[k] = __ballot_sync(0xffffffffu, r < na && va[r] != 0) >> (2 * q);
    }
    Top2 st0{NEG, NEG, 0};
    Top2 st1{NEG, NEG, 0};
    float acc_s[64];
    float acc_t[64];
    int it = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int col0 = col_begin + t * BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc_s[i] = acc_t[i] = 0.0f;
      fence_acc(acc_s);
      fence_acc(acc_t);
      for (int c = 0; c < k_chunks; ++c, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full_bar[s], (it / STAGES) & 1);
        const uint8_t* a_tile = smem + s * STAGE_BYTES;
        const uint8_t* b_tile = a_tile + A_BYTES;
        const uint64_t a_own = smem_desc(a_tile + wg * (A_BYTES / 2));  // 64 rows (M)
        const uint64_t a_all = smem_desc(a_tile);                       // 128 rows (N)
        const uint64_t b_own = smem_desc(b_tile + wg * (B_BYTES / 2));  // 64 columns (M)
        const uint64_t b_all = smem_desc(b_tile);                       // 128 columns (N)
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {  // +32 bytes per k16 step, in 16-byte units
          wgmma_m64n128k16(acc_s, a_own + 2 * k, b_all + 2 * k);
          wgmma_m64n128k16(acc_t, b_own + 2 * k, a_all + 2 * k);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc_s);
        fence_acc(acc_t);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_bar[s]);
      }

      // Row top-2 over acc_s, in increasing column order; the tile's column validity
      // in the bit layout of rbits.
      uint32_t cbits[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = col0 + 32 * k + lane;
        cbits[k] = __ballot_sync(0xffffffffu, c < col_end && vb[c] != 0) >> (2 * q);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool cv = (cbits[j / 4] >> (8 * (j % 4) + e)) & 1u;
          const int c = col0 + 8 * j + 2 * q + e;
          vo_match::scan(st0, (rv0 && cv) ? acc_s[4 * j + e] : NEG, c);
          vo_match::scan(st1, (rv1 && cv) ? acc_s[4 * j + 2 + e] : NEG, c);
        }
      }

      // Column argmax over acc_t (fragment rows: columns c0, c1 of the tile; fragment
      // columns: the block's rows), in increasing row order; then the quad, with the
      // lower row winning a tie, and one global atomicMax per column and block.
      const int c0 = col0 + frag_row;
      const int c1 = c0 + 8;
      const bool cv0 = c0 < col_end && vb[c0] != 0;
      const bool cv1 = c1 < col_end && vb[c1] != 0;
      float b0 = NEG, b1 = NEG;
      int i0 = 0, i1 = 0;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool rv = (rbits[j / 4] >> (8 * (j % 4) + e)) & 1u;
          const int rl = 8 * j + 2 * q + e;
          const float u0 = (cv0 && rv) ? acc_t[4 * j + e] : NEG;
          const float u1 = (cv1 && rv) ? acc_t[4 * j + 2 + e] : NEG;
          if (u0 > b0) { b0 = u0; i0 = rl; }
          if (u1 > b1) { b1 = u1; i1 = rl; }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob0 = __shfl_xor_sync(0xffffffffu, b0, off);
        const int oi0 = __shfl_xor_sync(0xffffffffu, i0, off);
        const float ob1 = __shfl_xor_sync(0xffffffffu, b1, off);
        const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
        if (ob0 > b0 || (ob0 == b0 && oi0 < i0)) { b0 = ob0; i0 = oi0; }
        if (ob1 > b1 || (ob1 == b1 && oi1 < i1)) { b1 = ob1; i1 = oi1; }
      }
      if (q < 2) {
        const int c = q == 0 ? c0 : c1;
        const unsigned long long key =
            q == 0 ? col_key(b0, row0 + i0) : col_key(b1, row0 + i1);
        if (c < col_end && key > key_init) atomicMax(&colkey[c], key);
      }
    }

    // Merge the four lanes of a row (quad), then write this split's partial rows.
    vo_match::merge_lanes(st0, 1, 4);
    vo_match::merge_lanes(st1, 1, 4);
    if (q == 0) {
      const size_t base = static_cast<size_t>(split) * na;
      if (r0 < na) {
        part_best[base + r0] = st0.best;
        part_sec[base + r0] = st0.sec;
        part_idx[base + r0] = st0.idx;
      }
      if (r1 < na) {
        part_best[base + r1] = st1.best;
        part_sec[base + r1] = st1.sec;
        part_idx[base + r1] = st1.idx;
      }
    }
  }

  vo_match::merge_across_blocks<BM, THREADS>(row0, na, col_begin, col_end, part_best,
                                             part_sec, part_idx, colkey, tickets, nn12,
                                             top2, nn21);
}

}  // namespace

// Error codes: a cudaError_t, or those of vo_match::encode_operands.
extern "C" int vo_top2_mutual_wgmma(const void* A, const void* B, const uint8_t* va,
                                    const uint8_t* vb, int na, int nb, int d,
                                    int n_row_tiles, int splits, int tiles_per_split,
                                    float* part_best, float* part_sec, int* part_idx,
                                    unsigned long long* colkey, unsigned int* tickets,
                                    int* nn12, float* top2, int* nn21, void* stream) {
  CUtensorMap map_a, map_b;
  const int res = vo_match::encode_operands(&map_a, &map_b, A, B, na, nb, d,
                                            CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BM);
  if (res != 0) return res;
  const cudaError_t err = cudaFuncSetAttribute(
      top2_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  top2_wgmma_kernel<<<dim3(n_row_tiles, splits), THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, va, vb, na, nb, (d + BK - 1) / BK, tiles_per_split, part_best, part_sec,
      part_idx, colkey, tickets, nn12, top2, nn21);
  return static_cast<int>(cudaGetLastError());
}
