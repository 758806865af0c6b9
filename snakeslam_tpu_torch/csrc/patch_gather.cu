// Tile-unit block gather: (B, N) blocks of (size_y, size_x) floats copied
// out of (B, H, W) images.
//
// Replaces the TPU kernel snakeslam_tpu/ops/orb_pallas.py
// (patch_gather_pallas, kernel body _patch_kernel).  Same API: block (b, i)
// starts at row y_tile[b, i] * 8 and column x_tile[b, i] * 128 of image b,
// size_y % 8 == 0 and size_x % 128 == 0.  The wrapper
// (ops/orb_kernels.py::patch_gather) checks that every block lies inside
// its image before the launch; the kernel does not check again.
//
// The Pallas kernel keeps 8 block DMAs in flight per grid program because
// vmapped dynamic_slice lowered to a slow gather on the TPU.  Here one
// thread block of 256 threads copies one (b, i) block row by row: with
// W % 4 == 0 and a 16-byte aligned image every block row starts 16-byte
// aligned (x is a multiple of 128 floats), so each thread moves float4s and
// a warp reads 512 contiguous bytes; otherwise it moves single floats.  The
// copy is exact: no arithmetic touches the values.
//
// What bounds it on Hopper: device-memory bandwidth, 2 x 4 bytes per
// float copied (read + write); ~B*N blocks in flight fill all SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpatch_gather.so patch_gather.cu
// Bound with ctypes (snakeslam_tpu_torch/ops/orb_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const float* __restrict__ imgs,
                    const int32_t* __restrict__ y_tile,
                    const int32_t* __restrict__ x_tile, int H, int W, int N,
                    int size_y, int size_x, int vec,
                    float* __restrict__ out) {
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const size_t k = static_cast<size_t>(b) * N + i;
  const int y = y_tile[k] * 8;
  const int x = x_tile[k] * 128;
  const float* src = imgs + (static_cast<size_t>(b) * H + y) * W + x;
  float* dst = out + k * size_y * size_x;
  if (vec) {
    const int q = size_x / 4;  // float4s per block row
    for (int e = threadIdx.x; e < size_y * q; e += kThreads) {
      const int r = e / q, c = e % q;
      const float4 v =
          reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * W)[c];
      reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * size_x)[c] = v;
    }
  } else {
    for (int e = threadIdx.x; e < size_y * size_x; e += kThreads) {
      const int r = e / size_x, c = e % size_x;
      dst[static_cast<size_t>(r) * size_x + c] =
          src[static_cast<size_t>(r) * W + c];
    }
  }
}

}  // namespace

// imgs: (B, H, W) float32; y_tile, x_tile: (B, N) int32; out: (B, N,
// size_y, size_x) float32; all contiguous on the device.  ``vec`` selects
// float4 copies (the caller guarantees W % 4 == 0 and a 16-byte aligned
// ``imgs``).  Launches on ``stream`` and returns the launch's cudaError_t.
extern "C" int snk_patch_gather(const void* imgs, const void* y_tile,
                                const void* x_tile, int B, int H, int W,
                                int N, int size_y, int size_x, int vec,
                                void* out, void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid(N, B);
  patch_gather_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const int32_t*>(y_tile),
      static_cast<const int32_t*>(x_tile), H, W, N, size_y, size_x, vec,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
