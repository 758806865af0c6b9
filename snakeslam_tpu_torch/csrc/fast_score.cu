// FAST-16 segment test and SAD corner score over a stacked batch of images.
//
// Replaces the TPU kernel snakeslam_tpu/ops/orb_pallas.py
// (fast_score_pallas_batch, kernel body _fast_kernel).  Same arithmetic:
//   * for the 16 FAST_RING offsets k = 0..15 (snakeslam_tpu/ops/orb.py), in
//     that order: bright = ring > c + th, dark = ring < c - th; set bit k of
//     the bright / dark mask; add (ring - c) - th to the bright sum or
//     (c - ring) - th to the dark sum, in f32, exactly as written;
//   * corner = 9 contiguous bits on the 16-bit ring, tested by doubling the
//     mask so that a rotation is a shift;
//   * score = max(bright sum, dark sum) at corners, else 0;
//   * both outputs are zeroed outside 3 <= y < H-3, 3 <= x < W-3 of each
//     image.
// The plain version (ops/orb_kernels.py::fast_score_batch_reference) sums
// in the same order, so the two agree bit for bit.  Build without
// --use_fast_math; nothing here is a multiply, so there is no FMA to
// contract.
//
// What it computes, not how the TPU did it: the Pallas kernel DMAs row
// bands plus a halo into VMEM because overlapping reads cannot be tiled
// with BlockSpecs.  Here one thread computes one output pixel; a 32x8 block
// stages its tile plus a 3-px halo (38x14 floats) in shared memory, so each
// image pixel is read from device memory ~1.6 times instead of 17.
// blockIdx.z is the image, so the border test works in per-image
// coordinates and neighbouring images cannot leak into each other.
//
// What bounds it on Hopper: device-memory bytes.  Per pixel it reads 4 and
// writes 5 bytes and does ~100 simple ALU operations, far below the ALU
// rate; 64 views of 480x752 are ~0.2 GB of traffic, tens of microseconds at
// 3 TB/s.  The ALU work runs from shared memory with no bank conflicts
// between neighbouring threads (consecutive x).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfast_score.so fast_score.cu
// Bound with ctypes (snakeslam_tpu_torch/ops/orb_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kRadius = 3;
constexpr int kSmemX = kTileX + 2 * kRadius;
constexpr int kSmemY = kTileY + 2 * kRadius;

__device__ __forceinline__ bool arc9(uint32_t bits) {
  const uint32_t m = bits | (bits << 16);
  uint32_t acc = m;
#pragma unroll
  for (int k = 1; k < 9; ++k) acc &= m >> k;
  return (acc & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(kTileX * kTileY)
fast_kernel(const float* __restrict__ imgs, int H, int W, float th,
            float* __restrict__ score, uint8_t* __restrict__ corner) {
  __shared__ float tile[kSmemY][kSmemX];
  // FAST_RING (dx, dy), clockwise from 12 o'clock
  const int ring_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int ring_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

  const size_t plane = static_cast<size_t>(H) * W;
  const float* img = imgs + blockIdx.z * plane;
  const int gx0 = blockIdx.x * kTileX - kRadius;
  const int gy0 = blockIdx.y * kTileY - kRadius;
  // halo pixels outside the image only reach outputs in the 3-px border,
  // which is zeroed: load them as 0
  for (int i = threadIdx.y * kTileX + threadIdx.x; i < kSmemY * kSmemX;
       i += kTileX * kTileY) {
    const int ty = i / kSmemX, tx = i % kSmemX;
    const int gy = gy0 + ty, gx = gx0 + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? img[static_cast<size_t>(gy) * W + gx]
                       : 0.0f;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int sx = threadIdx.x + kRadius, sy = threadIdx.y + kRadius;
  const float c = tile[sy][sx];
  const float hi = c + th;
  const float lo = c - th;
  uint32_t bits_b = 0u, bits_d = 0u;
  float sum_b = 0.0f, sum_d = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float r = tile[sy + ring_dy[k]][sx + ring_dx[k]];
    if (r > hi) {
      bits_b |= 1u << k;
      sum_b = sum_b + ((r - c) - th);
    }
    if (r < lo) {
      bits_d |= 1u << k;
      sum_d = sum_d + ((c - r) - th);
    }
  }
  const bool inside = y >= kRadius && y < H - kRadius && x >= kRadius &&
                      x < W - kRadius;
  const bool is_corner = inside && (arc9(bits_b) || arc9(bits_d));
  const size_t o = blockIdx.z * plane + static_cast<size_t>(y) * W + x;
  score[o] = is_corner ? fmaxf(sum_b, sum_d) : 0.0f;
  corner[o] = is_corner ? 1 : 0;
}

}  // namespace

// imgs, score: (B, H, W) float32; corner: (B, H, W) bytes (torch.bool);
// all contiguous on the device.  Launches on ``stream`` and returns the
// launch's cudaError_t (0 on success); does not synchronize.
extern "C" int snk_fast_score(const void* imgs, int B, int H, int W,
                              float threshold, void* score, void* corner,
                              void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  fast_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), H, W, threshold,
      static_cast<float*>(score), static_cast<uint8_t*>(corner));
  return static_cast<int>(cudaGetLastError());
}
