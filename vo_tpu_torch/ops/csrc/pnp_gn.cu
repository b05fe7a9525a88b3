// PnP's reweighted Gauss-Newton solve over SE(3) as one thread block: the whole
// threshold schedule in one launch. Plain C interface loaded through ctypes
// (vo_tpu_torch/ops/match.py builds every file of this directory with nvcc at first
// use; vo_tpu_torch/ops/pnp_gn.py launches it).
//
// Replaces no TPU kernel: the JAX package's vo_tpu/estimation/pnp.py::_gn_refine is a
// Python loop that XLA unrolls and fuses. Its PyTorch form
// (vo_tpu_torch/estimation/pnp.py::_gn_refine_plain, the plain version) launches ~330
// small kernels an iteration on the card. Per iteration, with pose (R, t), threshold
// thr and each point X_n, x_n:
//   Y = R X + t;  z_ok = Y_z > min_depth;  z = z_ok ? Y_z : 1
//   r = (fx Y_x / z + cx - x_x, fy Y_y / z + cy - x_y);  w = valid & z_ok & |r| < thr
//   J = J_proj(Y) [I | -hat(Y)]  (2 x 6);  A = sum w J^T J + 1e-6 I;  b = sum w J^T r
//   delta = -A^{-1} b (unrolled Cholesky, clamp 1e-12; ops/smalllinalg.py's order),
//   zeroed unless sum w >= 4;  pose = se3_exp(delta) pose (geometry/se3.py's branches).
//
// What bounds it on an H100: latency. A solve is a chain of dependent iterations; at
// N = 2048 and 10 iterations its ~3 MFLOP and ~43 KB would take ~0.05 us at the fp32
// peak and the HBM rate. So one block of 512 threads carries one solve from start to
// end on one SM:
//   * the pose and the schedule stay in shared memory and the kernel's parameters; the
//     points are read through the read-only cache (43 KB at N = 2048: L1 hits after the
//     first iteration), a thread taking points tid, tid + 512, ...;
//   * each thread accumulates the 21 lower entries of J^T W J, the 6 of J^T W r and
//     sum w in registers, in fp32 (w multiplies the Jacobian as in the plain version,
//     so a non-finite point poisons the sums as it does there);
//   * the block reduces them in a fixed tree, warp shuffles then the warps in order in
//     shared memory, without atomics: every call on the same inputs gives the same bits;
//   * one thread solves the 6 x 6 system, applies the exponential map and writes the
//     new pose to shared memory for the next iteration.
// fp32 throughout, with IEEE division and square root (no fast-math). A schedule longer
// than MAX_STEPS runs as several launches that hand the pose on through pose_out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STEPS = 64;
constexpr int SUMS = 28;               // 21 of J^T W J (lower), 6 of J^T W r, sum w
constexpr float CHOL_EPS = 1e-12f;     // ops/smalllinalg.py: _EPS
constexpr float EXP_EPS2 = 1e-16f;     // geometry/se3.py, so3.py: _EPS ** 2
constexpr float EXP_EPS3 = 1e-24f;     // _EPS ** 3

struct Schedule {
  float thr[MAX_STEPS];
};

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// delta = -A^{-1} b by ops/smalllinalg.py's unrolled Cholesky and substitutions; A is
// the lower triangle in row order, b the right-hand side.
__device__ void solve6(const float* sums, float delta[6]) {
  float A[6][6], L[6][6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = sums[k++];
    A[i][i] = A[i][i] + 1e-6f;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = s - L[j][q] * L[j][q];
    const float d = sqrtf(clamp_min(s, CHOL_EPS));
    L[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s2 = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) s2 = s2 - L[i][q] * L[j][q];
      L[i][j] = s2 * inv_d;
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = sums[21 + i];
#pragma unroll
    for (int q = 0; q < i; ++q) s = s - L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s = s - L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = -x[i];
}

// P <- se3_exp(delta) P, with P row-major 4 x 4 (geometry/se3.py: se3_exp, so3_exp).
__device__ void apply_exp(const float delta[6], float* P) {
  const float v[3] = {delta[0], delta[1], delta[2]};
  const float w0 = delta[3], w1 = delta[4], w2 = delta[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + EXP_EPS2);
  const bool small = th2 < 1e-8f;
  const float s = sinf(th), c = cosf(th);
  const float a = small ? 1.0f - th2 / 6.0f : s / th;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - c) / clamp_min(th2, EXP_EPS2);
  const float cc = small ? 1.0f / 6.0f - th2 / 120.0f
                         : (th - s) / clamp_min(th2 * th, EXP_EPS3);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = eye + a * W[i][j] + b * W2[i][j];
      t += (eye + b * W[i][j] + cc * W2[i][j]) * v[j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  float out[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = E[i][0] * P[j] + E[i][1] * P[4 + j] + E[i][2] * P[8 + j] + E[i][3] * P[12 + j];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = out[k];
}

__global__ void __launch_bounds__(THREADS, 1)
pnp_gn_kernel(const float* __restrict__ pose_in, const float* __restrict__ X,
              const float* __restrict__ xpx, const uint8_t* __restrict__ valid,
              const float* __restrict__ K, const Schedule sched, int steps, float min_depth,
              int n, float* __restrict__ pose_out) {
  __shared__ float P[16];
  __shared__ float red[WARPS][SUMS];
  __shared__ float tot[SUMS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 16) P[tid] = pose_in[tid];
  const float fx = __ldg(K + 0), cx = __ldg(K + 2), fy = __ldg(K + 4), cy = __ldg(K + 5);
  __syncthreads();

  for (int it = 0; it < steps; ++it) {
    const float thr = sched.thr[it];
    const float r00 = P[0], r01 = P[1], r02 = P[2], t0 = P[3];
    const float r10 = P[4], r11 = P[5], r12 = P[6], t1 = P[7];
    const float r20 = P[8], r21 = P[9], r22 = P[10], t2 = P[11];
    float acc[SUMS];
#pragma unroll
    for (int s = 0; s < SUMS; ++s) acc[s] = 0.0f;
    for (int p = tid; p < n; p += THREADS) {
      const float X0 = __ldg(X + 3 * p), X1 = __ldg(X + 3 * p + 1), X2 = __ldg(X + 3 * p + 2);
      const float Y0 = r00 * X0 + r01 * X1 + r02 * X2 + t0;
      const float Y1 = r10 * X0 + r11 * X1 + r12 * X2 + t1;
      const float Y2 = r20 * X0 + r21 * X1 + r22 * X2 + t2;
      const bool z_ok = Y2 > min_depth;
      const float z = z_ok ? Y2 : 1.0f;
      const float res0 = fx * Y0 / z + cx - __ldg(xpx + 2 * p);
      const float res1 = fy * Y1 / z + cy - __ldg(xpx + 2 * p + 1);
      const float norm = sqrtf(res0 * res0 + res1 * res1);
      const float w = (__ldg(valid + p) && z_ok && norm < thr) ? 1.0f : 0.0f;
      const float zinv = 1.0f / z;
      const float ja = fx * zinv, jb = fy * zinv;
      const float jc = -fx * Y0 * zinv * zinv, jd = -fy * Y1 * zinv * zinv;
      // Rows of J = J_proj [I | -hat(Y)]; the structural zeros are left out.
      const float J0[6] = {ja, 0.0f, jc, jc * Y1, ja * Y2 - jc * Y0, -ja * Y1};
      const float J1[6] = {0.0f, jb, jd, jd * Y1 - jb * Y2, -jd * Y0, jb * Y0};
      float wJ0[6], wJ1[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        wJ0[i] = w * J0[i];
        wJ1[i] = w * J1[i];
      }
      int s = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) acc[s++] += wJ0[i] * J0[j] + wJ1[i] * J1[j];
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += wJ0[i] * res0 + wJ1[i] * res1;
      acc[27] += w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int s = 0; s < SUMS; ++s) acc[s] += __shfl_down_sync(0xffffffffu, acc[s], off);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < SUMS; ++s) red[warp][s] = acc[s];
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < SUMS) {
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) v += red[q][lane];
        tot[lane] = v;
      }
      __syncwarp();
      if (lane == 0) {
        float delta[6];
        solve6(tot, delta);
        if (!(tot[27] >= 4.0f)) {
#pragma unroll
          for (int i = 0; i < 6; ++i) delta[i] = 0.0f;
        }
        apply_exp(delta, P);
      }
    }
    __syncthreads();
  }
  if (tid < 16) pose_out[tid] = P[tid];
}

}  // namespace

// The solve from pose_in (4 x 4, row-major) over n points: X (n, 3), xpx (n, 2), valid
// (n,) bytes, K (3, 3) row-major, all fp32 but valid and on the device; thresholds
// (n_steps,) on the host, one per iteration. Writes the final pose to pose_out, which
// must not alias pose_in. Launches ceil(n_steps / MAX_STEPS) kernels on ``stream``
// (none for an empty schedule) and returns the CUDA error of the last, or 0.
extern "C" int vo_pnp_gn(const float* pose_in, const float* X, const float* xpx,
                         const uint8_t* valid, const float* K, const float* thresholds,
                         int n_steps, float min_depth, int n, float* pose_out,
                         void* stream) {
  for (int first = 0; first < n_steps; first += MAX_STEPS) {
    const int steps = n_steps - first < MAX_STEPS ? n_steps - first : MAX_STEPS;
    Schedule sched;
    for (int i = 0; i < steps; ++i) sched.thr[i] = thresholds[first + i];
    pnp_gn_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        first == 0 ? pose_in : pose_out, X, xpx, valid, K, sched, steps, min_depth, n,
        pose_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The kernel launches vo_pnp_gn makes for a schedule of n_steps.
extern "C" int vo_pnp_gn_launches(int n_steps) {
  return (n_steps + MAX_STEPS - 1) / MAX_STEPS;
}
