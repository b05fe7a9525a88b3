// Pieces shared by the two match kernels (match_kernel.cu, match_wgmma.cu): the packed
// column key and the row top-2 merge with the tie rules of
// vo_tpu/ops/pallas_match.py::_match_kernel, the mbarrier / TMA helpers of their
// operand rings, and the merge across blocks that ends each call.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vo_match {

constexpr float NEG = -1e30f;

// The column argmax is an atomicMax on this key: the high 32 bits order the fp32
// similarity, the low 32 bits are 0xFFFFFFFF - row, so equal values go to the lowest
// row. col_key(NEG, 0) is XLA's argmax of an all-invalid column, and no key of a
// masked value (NEG, any row) exceeds it.
__device__ __forceinline__ unsigned long long col_key(float v, int row) {
  unsigned int u = __float_as_uint(v + 0.0f);  // -0 -> +0, so equal values tie
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned int>(row));
}

__device__ __forceinline__ int col_key_row(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(key & 0xFFFFFFFFull));
}

struct Top2 {
  float best;
  float sec;
  int idx;
};

// One value of a row, in increasing column order: a later equal value is a duplicate
// (the second), never the argmax.
__device__ __forceinline__ void scan(Top2& s, float v, int col) {
  if (v > s.best) {
    s.sec = fmaxf(s.sec, s.best);
    s.best = v;
    s.idx = col;
  } else {
    s.sec = fmaxf(s.sec, v);
  }
}

// Two partial states over disjoint columns: sec = max(sec1, sec2, min(best1, best2)),
// the lower index wins an equal best (pallas_match.py:82-85).
__device__ __forceinline__ void merge(Top2& a, float b_best, float b_sec, int b_idx) {
  const float sec = fmaxf(fmaxf(a.sec, b_sec), fminf(a.best, b_best));
  if (b_best > a.best || (b_best == a.best && b_idx < a.idx)) {
    a.best = b_best;
    a.idx = b_idx;
  }
  a.sec = sec;
}

// Merges the state of the lanes ``off``, ``2 off``, ... apart (xor shuffles).
__device__ __forceinline__ void merge_lanes(Top2& s, int off_begin, int off_end) {
  for (int off = off_begin; off < off_end; off <<= 1) {
    const float b = __shfl_xor_sync(0xffffffffu, s.best, off);
    const float c = __shfl_xor_sync(0xffffffffu, s.sec, off);
    const int i = __shfl_xor_sync(0xffffffffu, s.idx, off);
    merge(s, b, c, i);
  }
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of the given parity to complete. A wait that lasts seconds is a
// broken pipeline: it traps, so the caller gets an error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One box at (x = K offset, y = row) into shared memory, 128B-swizzled.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// ---- the end of a call: merge across blocks ----

// The block that is last (atomic ticket) among a row tile's splits merges that tile's
// partial rows and writes nn12 and top2 (threads 0..BM-1, one row each); the last among
// a split's row tiles writes nn21 for the split's columns from the packed keys (the
// other threads, or all of them). Each resets what it consumed (keys to
// col_key(NEG, 0), its ticket to 0), so the wrapper keeps that scratch across calls.
// Every thread of the block calls this once, after its partial rows and its column
// keys are written; the bar.sync makes those writes visible to the ticket threads,
// whose fence publishes them.
template <int BM, int THREADS>
__device__ __forceinline__ void merge_across_blocks(
    int row0, int na, int col_begin, int col_end, const float* part_best,
    const float* part_sec, const int* part_idx, unsigned long long* colkey,
    unsigned int* tickets, int* nn12, float* top2, int* nn21) {
  __shared__ bool last[2];
  const int tid = threadIdx.x;
  const int n_row_tiles = gridDim.x;
  const int splits = gridDim.y;
  const int row_tile = blockIdx.x;
  const int split = blockIdx.y;
  __syncthreads();
  if (tid == 0 || tid == 32) {
    __threadfence();
    last[tid / 32] = tid == 0 ? atomicAdd(&tickets[row_tile], 1u) == splits - 1u
                              : atomicAdd(&tickets[n_row_tiles + split], 1u) ==
                                    static_cast<unsigned int>(n_row_tiles - 1);
  }
  __syncthreads();
  const bool merge_rows = last[0];
  if (merge_rows && tid < BM && row0 + tid < na) {
    __threadfence();
    const int r = row0 + tid;
    Top2 s{__ldcg(part_best + r), __ldcg(part_sec + r), __ldcg(part_idx + r)};
#pragma unroll 8
    for (int p = 1; p < splits; ++p) {
      const size_t o = static_cast<size_t>(p) * na + r;
      merge(s, __ldcg(part_best + o), __ldcg(part_sec + o), __ldcg(part_idx + o));
    }
    nn12[r] = s.idx;
    top2[2 * r] = s.best;
    top2[2 * r + 1] = s.sec;
    if (tid == 0) tickets[row_tile] = 0u;
  }
  const int first = merge_rows ? BM : 0;
  if (last[1] && tid >= first) {
    __threadfence();
    for (int c = col_begin + tid - first; c < col_end; c += THREADS - first) {
      nn21[c] = col_key_row(__ldcg(colkey + c));
      colkey[c] = col_key(NEG, 0);
    }
    if (tid == first) tickets[n_row_tiles + split] = 0u;
  }
}

// ---- host side: tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched through the runtime's entry-point
// query, so the library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (rows, d) row-major operand in boxes of ``box_rows`` rows x one 128-byte row of K,
// 128B swizzle, zero fill past the edges.
inline CUresult encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
                           int rows, int d, CUtensorMapDataType type, int elem_bytes,
                           int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encodes both operands' maps; 0, or -1 (cuTensorMapEncodeTiled not found), or
// -1000 - CUresult (a map was refused).
inline int encode_operands(CUtensorMap* map_a, CUtensorMap* map_b, const void* A,
                           const void* B, int na, int nb, int d, CUtensorMapDataType type,
                           int elem_bytes, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUresult res = encode_map(encode, map_a, A, na, d, type, elem_bytes, box_rows);
  if (res == CUDA_SUCCESS) res = encode_map(encode, map_b, B, nb, d, type, elem_bytes, box_rows);
  return res == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(res);
}

}  // namespace vo_match
