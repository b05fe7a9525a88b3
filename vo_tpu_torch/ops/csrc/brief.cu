// Upright BRIEF at the keypoints: for each (frame, keypoint) row and each pair of the
// integer offsets table, one compare of two pixels of the blurred image rounded to bf16,
// written as a +-1 bf16 descriptor (0 rows for invalid keypoints), in one launch. Plain C
// interface loaded through ctypes (vo_tpu_torch/ops/kernels.py builds every file of this
// directory with nvcc at first use; vo_tpu_torch/ops/brief.py launches it).
//
// Replaces no Pallas kernel: the JAX package's vo_tpu/features/dense_brief.py builds
// each compare at every pixel of the batch (dense_packed_brief, which XLA fuses into
// packed words) and then gathers the words at the keypoints (gather_brief_descriptors).
// In PyTorch that dense form is ~4 elementwise kernels a bit over the whole batch, ~1.4
// ms of the card's time a frame at 256 bits, to keep 2,048 of 463,232 pixels. This kernel
// makes the same compares at the keypoints alone, with the dense path's bits:
//   xi = clamp(int64(kp_x), 0, W - 1), yi = clamp(int64(kp_y), 0, H - 1)  (truncation)
//   va = bf16(img[yi + ay][xi + ax]), 0 outside the image;  vb likewise at (bx, by)
//   desc[j] = va < vb ? +1 : -1, the j-th pair of the table;  0 on an invalid row
// where bf16() rounds to nearest even with NaN kept, as .to(torch.bfloat16) does, and the
// compare is the float compare of the two rounded values.
//
// What bounds it on an H100: bytes. At 16 frames of 376 x 1232, 2,048 keypoints a frame
// and 256 bits it writes 16.8 MB of descriptors and reads the 29.6 MB fp32 image at most
// once (the 27 x 27 patches of 2,048 keypoints cover most of a frame): ~14 us at 3.35
// TB/s. Its 8.4 M compares are nothing beside that. So one warp takes one row at a time,
// lane l making compares l, l + 32, ...: the warp writes 64 contiguous bytes a step, the
// validity test is uniform across it, and the row's two pixels per compare lie in one
// 27 x 27 patch, so the lanes' reads hit a few lines of L1. The offsets table is loaded
// into shared memory once per block, and the blocks walk the rows grid-stride.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 1056;                  // 8 resident blocks on each of 132 SMs
constexpr unsigned short PLUS_ONE = 0x3F80u;      // bf16 +1
constexpr unsigned short MINUS_ONE = 0xBF80u;     // bf16 -1

// A pixel of one frame rounded to bf16, or the zero padding outside the frame.
__device__ __forceinline__ float pixel(const float* __restrict__ frame, int H, int W,
                                       long long y, long long x) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.0f;
  return __bfloat162float(__float2bfloat16_rn(__ldg(frame + y * W + x)));
}

__global__ void __launch_bounds__(THREADS)
brief_kernel(const float* __restrict__ img, const float* __restrict__ kp,
             const uint8_t* __restrict__ valid, const int4* __restrict__ offsets, int H,
             int W, int K, long long rows, int bits, unsigned short* __restrict__ out) {
  extern __shared__ int4 table[];                 // (ax, ay, bx, by) of each pair
  for (int j = threadIdx.x; j < bits; j += THREADS) table[j] = offsets[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       row < rows; row += stride) {
    unsigned short* o = out + row * bits;
    if (!valid[row]) {
      for (int j = lane; j < bits; j += 32) o[j] = 0;
      continue;
    }
    // float -> int64 truncates (and saturates, NaN to 0) as torch's CUDA cast does.
    long long xi = static_cast<long long>(kp[2 * row]);
    long long yi = static_cast<long long>(kp[2 * row + 1]);
    xi = xi < 0 ? 0 : (xi > W - 1 ? W - 1 : xi);
    yi = yi < 0 ? 0 : (yi > H - 1 ? H - 1 : yi);
    const float* frame = img + (row / K) * static_cast<long long>(H) * W;
    for (int j = lane; j < bits; j += 32) {
      const int4 t = table[j];
      const float va = pixel(frame, H, W, yi + t.y, xi + t.x);
      const float vb = pixel(frame, H, W, yi + t.w, xi + t.z);
      o[j] = va < vb ? PLUS_ONE : MINUS_ONE;
    }
  }
}

}  // namespace

// img (B, H, W) fp32, kp (B, K, 2) fp32 [x, y], valid (B, K) bool, offsets (bits, 2, 2)
// int32 [pair, point, (dx, dy)], out (B, K, bits) bf16; all contiguous on one device.
// bits is a multiple of 32 no larger than 2048 (the wrapper checks).
extern "C" int vo_brief(const float* img, const float* kp, const uint8_t* valid,
                        const int* offsets, int B, int H, int W, int K, int bits,
                        void* out, void* stream) {
  const long long rows = static_cast<long long>(B) * K;
  if (rows == 0) return 0;
  long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  brief_kernel<<<static_cast<unsigned>(blocks), THREADS, bits * sizeof(int4),
                 static_cast<cudaStream_t>(stream)>>>(
      img, kp, valid, reinterpret_cast<const int4*>(offsets), H, W, K, rows, bits,
      static_cast<unsigned short*>(out));
  return static_cast<int>(cudaGetLastError());
}
