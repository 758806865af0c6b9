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
// contract.  The plain version adds an exact +0.0f through torch.where
// where a pixel is not bright (dark); the kernel adds nothing there, which
// gives the same bits: x + 0.0f is x for every sum this can reach (a sum
// starts at +0.0f and never becomes -0.0f).
//
// What bounds it on Hopper: device-memory bytes.  Per pixel it must read 4
// bytes and write 5 (score and corner flag): 9 B/px, 207.9 MB and 62.1 us
// at 3.35 TB/s for 64 views of 480x752.  The first design (one pixel a
// thread, a 32x8 tile, 16 shared-memory reads with two branches each for
// every pixel, scalar stores) was bound by its instruction count instead,
// at ~18% of the bytes bound: a warp ran the full ring for every pixel.
// This one cuts the instructions a pixel:
//   * a thread owns a run of 4 horizontally adjacent pixels in each of 2
//     rows; a 32x8 block covers a 128x16 tile and stages its 136x22 f32
//     halo tile (3 rows above and below, 4 columns left and right so that
//     every row is whole float4s; 11.7 KB) in shared memory, row by row
//     with threads across columns and no division, as asynchronous copies
//     all in flight at once: 16 bytes each when the image rows are 16-byte
//     aligned (W % 4 == 0, as at level 0), 4 bytes otherwise (levels 1-3),
//     zero-filled outside the image;
//   * an exact early reject: any 9 contiguous ring positions hold at least
//     2 of the compass positions {0, 4, 8, 12}, and 2 that are adjacent on
//     the ring (9 consecutive integers hold two consecutive multiples of
//     4): so a pixel whose compass pixels hold no bright pair (N or S) and
//     (E or W), and no such dark pair (the same strict comparisons), is no
//     corner.  This implies the test "fewer than 2 bright and fewer than 2
//     dark" and is cheaper (predicate logic, no counts).  A run's centres
//     and compass pixels are 5 conflict-free float4 reads of shared memory;
//   * the pixels of a warp's two rows that pass are compacted (a shuffle
//     prefix sum into a list in shared memory) and the warp's lanes take
//     them one each, so the full 16-pixel test runs on full warps only for
//     the pixels that need it, not for every pixel of a warp with one
//     passer; it forms both bit masks and both sums in one pass over the
//     ring (9-arcs by doubling: runs of 2, 4, 8, then 9);
//   * one float4 score store and one 32-bit store of the 4 corner bytes a
//     run where the rows are aligned, scalar stores at the ragged edge.
// blockIdx.z is the image, so the border test works in per-image
// coordinates and neighbouring images cannot leak into each other.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfast_score.so fast_score.cu
// Bound with ctypes (snakeslam_tpu_torch/ops/orb_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRun = 4;                      // adjacent pixels a thread
constexpr int kThreadsX = 32;                // one warp a tile row
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = 2;
constexpr int kTileX = kThreadsX * kRun;     // 128 output columns
constexpr int kTileY = kThreadsY * kRowsPerThread;  // 16 output rows
constexpr int kRadius = 3;
constexpr int kPadX = 4;                     // the 3-px halo, whole float4s
constexpr int kSmemX = kTileX + 2 * kPadX;   // 136
constexpr int kSmemY = kTileY + 2 * kRadius; // 22
constexpr int kVecX = kSmemX / 4;            // 34 float4s a tile row

// 9 contiguous set bits on the 16-bit ring: runs of 2, 4, 8, then 9 on the
// doubled mask, so that a rotation is a shift
__device__ __forceinline__ bool arc9(uint32_t bits) {
  const uint32_t m = bits | (bits << 16);
  const uint32_t r2 = m & (m >> 1);
  const uint32_t r4 = r2 & (r2 >> 2);
  const uint32_t r8 = r4 & (r4 >> 4);
  return ((r8 & (m >> 8)) & 0xFFFFu) != 0u;
}

// cp.async of kBytes from global to shared memory; zeros when !in
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? kBytes : 0;
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fast_kernel(const float* __restrict__ imgs, int H, int W, float th, int vec,
            float* __restrict__ score, uint8_t* __restrict__ corner) {
  __shared__ __align__(16) float tile[kSmemY][kSmemX];
  // per warp: its two rows' pixels that pass the compass test, and their
  // results, indexed by pixel (row * 128 + column in the tile)
  __shared__ uint8_t s_list[kThreadsY][kRowsPerThread * kTileX];
  __shared__ __align__(16) float s_score[kThreadsY][kRowsPerThread * kTileX];
  __shared__ __align__(16) uint8_t s_corner[kThreadsY][kRowsPerThread * kTileX];
  // FAST_RING (dx, dy), clockwise from 12 o'clock
  const int ring_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int ring_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

  const size_t plane = static_cast<size_t>(H) * W;
  const float* img = imgs + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int gx0 = x0 - kPadX;    // image column of tile column 0
  const int gy0 = y0 - kRadius;  // image row of tile row 0
  const int lane = threadIdx.x;  // a warp is one threadIdx.y
  const int warp = threadIdx.y;

  // halo pixels outside the image only reach outputs in the 3-px border,
  // which is zeroed: load them as 0.  Asynchronous copies (cp.async, the
  // source size 0 outside the image fills zeros), all in flight at once:
  // warp w copies tile rows w, w + 8, w + 16, its lanes across the row.
#pragma unroll
  for (int m = 0; m < (kSmemY + kThreadsY - 1) / kThreadsY; ++m) {
    const int r = warp + m * kThreadsY;
    if (r < kSmemY) {
      const int gy = gy0 + r;
      const bool row_in = gy >= 0 && gy < H;
      const float* src = img + static_cast<size_t>(row_in ? gy : 0) * W;
      if (vec) {
        // W % 4 == 0 and gx % 4 == 0: a float4 is wholly in or wholly out
#pragma unroll
        for (int u = 0; u < (kVecX + kThreadsX - 1) / kThreadsX; ++u) {
          const int q = lane + u * kThreadsX;
          const int gx = gx0 + 4 * q;
          const bool in = row_in && gx >= 0 && gx < W;
          if (q < kVecX) copy_async<16>(&tile[r][4 * q], src + (in ? gx : 0), in);
        }
      } else {
#pragma unroll
        for (int u = 0; u < (kSmemX + kThreadsX - 1) / kThreadsX; ++u) {
          const int c = lane + u * kThreadsX;
          const int gx = gx0 + c;
          const bool in = row_in && gx >= 0 && gx < W;
          if (c < kSmemX) copy_async<4>(&tile[r][c], src + (in ? gx : 0), in);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int x = x0 + kRun * lane;           // first pixel of the run
  const int n_run = min(kRun, W - x);       // its pixels in the image
  const int sx = kRun * lane + kPadX;       // its tile column
  // the run's pixels inside the 3-px border, as bits j
  uint32_t x_inside = 0u;
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    x_inside |= static_cast<uint32_t>(x + j >= kRadius && x + j < W - kRadius) << j;
  // the compass test on the warp's two rows: bit i * 4 + j of ``pass`` is
  // pixel j of the run in row i
  uint32_t pass = 0u;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int sy = warp + i * kThreadsY + kRadius;   // the row's tile row
    const int y = y0 + sy - kRadius;
    // the run's centres and compass pixels: ring 0 (north), 4 (east),
    // 8 (south), 12 (west)
    const float4 c4 = *reinterpret_cast<const float4*>(&tile[sy][sx]);
    const float4 w4 = *reinterpret_cast<const float4*>(&tile[sy][sx - 4]);
    const float4 e4 = *reinterpret_cast<const float4*>(&tile[sy][sx + 4]);
    const float4 n4 = *reinterpret_cast<const float4*>(&tile[sy - 3][sx]);
    const float4 s4 = *reinterpret_cast<const float4*>(&tile[sy + 3][sx]);
    const float cv[kRun] = {c4.x, c4.y, c4.z, c4.w};
    const float nv[kRun] = {n4.x, n4.y, n4.z, n4.w};
    const float ev[kRun] = {c4.w, e4.x, e4.y, e4.z};
    const float sv[kRun] = {s4.x, s4.y, s4.z, s4.w};
    const float wv[kRun] = {w4.y, w4.z, w4.w, c4.x};
    uint32_t row_pass = 0u;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const float hi = cv[j] + th;
      const float lo = cv[j] - th;
      // bright (dark) at two adjacent compass pixels: N or S, and E or W
      // (bitwise, so that no branch is taken)
      const bool pass_b =
          ((nv[j] > hi) | (sv[j] > hi)) & ((ev[j] > hi) | (wv[j] > hi));
      const bool pass_d =
          ((nv[j] < lo) | (sv[j] < lo)) & ((ev[j] < lo) | (wv[j] < lo));
      row_pass |= static_cast<uint32_t>(pass_b | pass_d) << j;
    }
    if (y >= kRadius && y < H - kRadius)
      pass |= (row_pass & x_inside) << (i * kRun);
  }
  // compact the warp's passing pixels into its list
  const int cnt = __popc(pass);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int pos = incl - cnt;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (pass & (1u << (i * kRun + j)))
        s_list[warp][pos++] = static_cast<uint8_t>(i * kTileX + kRun * lane + j);
  __syncwarp();
  // the full test, one passing pixel a lane
  for (int q = lane; q < total; q += kThreadsX) {
    const int id = s_list[warp][q];
    const int sy = warp + (id >> 7) * kThreadsY + kRadius;
    const int col = (id & (kTileX - 1)) + kPadX;
    const float c = tile[sy][col];
    const float hi = c + th;
    const float lo = c - th;
    // bright / dark masks and sums in one pass, in ring order; the sums
    // add a term only where the pixel is bright (dark), as a branch would
    uint32_t bits_b = 0u, bits_d = 0u;
    float sum_b = 0.0f, sum_d = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float r = tile[sy + ring_dy[k]][col + ring_dx[k]];
      // (c - r) rounds to exactly -(r - c), so the dark term (c - r) - th
      // is -t - th with t = r - c
      const float t = r - c;
      if (r > hi) {
        bits_b |= 1u << k;
        sum_b = sum_b + (t - th);
      }
      if (r < lo) {
        bits_d |= 1u << k;
        sum_d = sum_d + (-t - th);
      }
    }
    const bool is_corner = arc9(bits_b) || arc9(bits_d);
    const float out = is_corner ? fmaxf(sum_b, sum_d) : 0.0f;
    s_score[warp][id] = out;
    s_corner[warp][id] = is_corner ? 1 : 0;
  }
  __syncwarp();
  if (n_run <= 0) return;
  // back to the runs' owners: results of passing pixels, 0 elsewhere
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int y = y0 + warp + i * kThreadsY;
    if (y >= H) break;
    const int id0 = i * kTileX + kRun * lane;
    const uint32_t pb = pass >> (i * kRun);
    const float4 r4 = *reinterpret_cast<const float4*>(&s_score[warp][id0]);
    const uint32_t rc = *reinterpret_cast<const uint32_t*>(&s_corner[warp][id0]);
    const float sc[kRun] = {pb & 1u ? r4.x : 0.0f, pb & 2u ? r4.y : 0.0f,
                            pb & 4u ? r4.z : 0.0f, pb & 8u ? r4.w : 0.0f};
    const uint32_t keep = (pb & 1u ? 0xFFu : 0u) | (pb & 2u ? 0xFF00u : 0u) |
                          (pb & 4u ? 0xFF0000u : 0u) |
                          (pb & 8u ? 0xFF000000u : 0u);
    const uint32_t cf = rc & keep;
    const size_t o = blockIdx.z * plane + static_cast<size_t>(y) * W + x;
    if (vec && n_run == kRun) {
      *reinterpret_cast<float4*>(score + o) =
          make_float4(sc[0], sc[1], sc[2], sc[3]);
      *reinterpret_cast<uint32_t*>(corner + o) = cf;
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (j < n_run) {
          score[o + j] = sc[j];
          corner[o + j] = static_cast<uint8_t>(cf >> (8 * j));
        }
    }
  }
}

}  // namespace

// imgs, score: (B, H, W) float32; corner: (B, H, W) bytes (torch.bool);
// all contiguous on the device.  Launches on ``stream`` and returns the
// launch's cudaError_t (0 on success); does not synchronize.
extern "C" int snk_fast_score(const void* imgs, int B, int H, int W,
                              float threshold, void* score, void* corner,
                              void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  // 16-byte rows: whole float4 loads and stores, 4-byte corner stores
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(imgs) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(score) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(corner) % 4 == 0;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  fast_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), H, W, threshold, vec,
      static_cast<float*>(score), static_cast<uint8_t*>(corner));
  return static_cast<int>(cudaGetLastError());
}
