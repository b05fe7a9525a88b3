// Pieces shared by the two match kernels (match_kernel.cu, match_wgmma.cu): the packed
// column key and the row top-2 merge, with the tie rules of
// vo_tpu/ops/pallas_match.py::_match_kernel.
#pragma once

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

}  // namespace vo_match
