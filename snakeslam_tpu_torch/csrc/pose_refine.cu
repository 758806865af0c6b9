// Fused robust pose refine: a whole robust Gauss-Newton pose solve in one
// launch, one thread block per problem.
//
// Replaces the TPU kernel snakeslam_tpu/ops/pose_pallas.py
// (pose_refine_fused, kernel body _pose_refine_kernel).  Same semantics:
//   * outer_iters rounds of (inner_iters damped GN steps -> chi2
//     reclassification of the inliers);
//   * Huber weights at sqrt(chi2 + 1e-12) against the mono / stereo pixel
//     thresholds, depth gate Z > 1e-4;
//   * 21 H sums plus 6 b sums per GN step, damping on the diagonal, a
//     closed-form 3x3-block Schur solve, left-multiplied SE3 exponential;
//   * the hat-block Jacobian terms use the raw Z, not the clamped one; the
//     stereo third row is scaled by the stereo flag;
//   * the rotation is re-orthonormalized by column-wise Gram-Schmidt at the
//     end, not between steps.
//
// What bounds it on Hopper: latency, not bytes or FLOPs.  A problem of
// N = 1024 features reads about 32 KB per GN step, on one SM, and each GN
// step is a block reduction followed by a serial scalar solve on one
// thread: 3 to 4 dependent reduce -> solve -> broadcast rounds per call.
// The design keeps every feature in shared memory for the whole call (one
// global read), reduces in a fixed order with no atomics (warp shuffles,
// then one partial per warp in shared memory, then warp 0), so results are
// bit-identical from run to run, and writes the inlier count itself so the
// caller needs no extra reduction launch.  Batched: B problems, B blocks.
// Inside the windowed tracking loop the many small PyTorch launches around
// this kernel dominate until the window is captured as a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpose_refine.so pose_refine.cu
// Bound with ctypes (snakeslam_tpu_torch/ops/pose_fused.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 upper-triangle H entries + 6 b entries
constexpr int kFields = 7; // px py pz u v right w^2 (floats in shared memory)

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// closed-form 3x3 inverse via the adjugate (ops/linalg.inv3x3)
__device__ void inv3(const float m[3][3], float out[3][3]) {
  const float a = m[0][0], b = m[0][1], c = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float g = m[2][0], h = m[2][1], i = m[2][2];
  const float A11 = e * i - f * h;
  const float A12 = c * h - b * i;
  const float A13 = b * f - c * e;
  const float A21 = f * g - d * i;
  const float A22 = a * i - c * g;
  const float A23 = c * d - a * f;
  const float A31 = d * h - e * g;
  const float A32 = b * g - a * h;
  const float A33 = a * e - b * d;
  float det = a * A11 + b * A21 + c * A31;
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  out[0][0] = A11 / det; out[0][1] = A12 / det; out[0][2] = A13 / det;
  out[1][0] = A21 / det; out[1][1] = A22 / det; out[1][2] = A23 / det;
  out[2][0] = A31 / det; out[2][1] = A32 / det; out[2][2] = A33 / det;
}

// 6x6 PSD solve by 3x3 block Schur elimination: H = [[A, B], [B^T, D]]
__device__ void solve6(const float H[6][6], const float rhs[6], float x[6]) {
  float A[3][3], B[3][3], D[3][3], Ai[3][3], BtAi[3][3], S[3][3], Si[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      A[r][c] = H[r][c];
      B[r][c] = H[r][c + 3];
      D[r][c] = H[r + 3][c + 3];
    }
  inv3(A, Ai);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      BtAi[r][c] = B[0][r] * Ai[0][c] + B[1][r] * Ai[1][c] + B[2][r] * Ai[2][c];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      S[r][c] = D[r][c] - (BtAi[r][0] * B[0][c] + BtAi[r][1] * B[1][c] +
                           BtAi[r][2] * B[2][c]);
  float rhs2[3], rhs1[3];
  for (int r = 0; r < 3; ++r)
    rhs2[r] = rhs[3 + r] - (BtAi[r][0] * rhs[0] + BtAi[r][1] * rhs[1] +
                            BtAi[r][2] * rhs[2]);
  inv3(S, Si);
  for (int r = 0; r < 3; ++r)
    x[3 + r] = Si[r][0] * rhs2[0] + Si[r][1] * rhs2[1] + Si[r][2] * rhs2[2];
  for (int r = 0; r < 3; ++r)
    rhs1[r] = rhs[r] - (B[r][0] * x[3] + B[r][1] * x[4] + B[r][2] * x[5]);
  for (int r = 0; r < 3; ++r)
    x[r] = Ai[r][0] * rhs1[0] + Ai[r][1] * rhs1[1] + Ai[r][2] * rhs1[2];
}

// SE3 exponential, Sophus ordering (upsilon v, omega w) -> R, t
__device__ void se3_exp(const float v[3], const float w[3], float R[3][3],
                        float t[3]) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(th2 + 1e-30f);
  const bool small = th < 1e-4f;
  const float a = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float bb = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / (th2 + 1e-30f);
  const float cc = small ? 1.0f / 6.0f - th2 / 120.0f
                         : (th - sinf(th)) / (th2 * th + 1e-30f);
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]},
                         {-w[1], w[0], 0.0f}};
  float W2[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      W2[r][c] = W[r][0] * W[0][c] + W[r][1] * W[1][c] + W[r][2] * W[2][c];
  float V[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      const float e = (r == c) ? 1.0f : 0.0f;
      R[r][c] = e + a * W[r][c] + bb * W2[r][c];
      V[r][c] = e + bb * W[r][c] + cc * W2[r][c];
    }
  for (int r = 0; r < 3; ++r)
    t[r] = V[r][0] * v[0] + V[r][1] * v[1] + V[r][2] * v[2];
}

// shared-memory view of one problem's features
struct Feats {
  const float* px; const float* py; const float* pz;
  const float* uo; const float* vo; const float* ro; const float* w2;
};

struct Residual {
  float X, Y, Z, iz, ru, rv, rr, chi2;
  bool z_ok, stereo;
};

__device__ __forceinline__ Residual residual(const Feats& F, int i,
                                             const float T[12], float fx,
                                             float fy, float cx, float cy,
                                             float bf) {
  Residual r;
  const float px = F.px[i], py = F.py[i], pz = F.pz[i];
  r.X = T[0] * px + T[1] * py + T[2] * pz + T[3];
  r.Y = T[4] * px + T[5] * py + T[6] * pz + T[7];
  r.Z = T[8] * px + T[9] * py + T[10] * pz + T[11];
  r.z_ok = r.Z > 1e-4f;
  const float zs = r.z_ok ? r.Z : 1.0f;
  r.iz = 1.0f / zs;
  const float u = fx * r.X * r.iz + cx;
  const float v = fy * r.Y * r.iz + cy;
  const float ro = F.ro[i];
  r.stereo = ro > 0.0f;
  r.ru = u - F.uo[i];
  r.rv = v - F.vo[i];
  r.rr = r.stereo ? u - bf * r.iz - ro : 0.0f;
  r.chi2 = F.w2[i] * (r.ru * r.ru + r.rv * r.rv + r.rr * r.rr);
  return r;
}

__global__ void __launch_bounds__(kThreads)
pose_refine_kernel(const float* __restrict__ T_init,
                   const float* __restrict__ points,
                   const float* __restrict__ uv,
                   const float* __restrict__ right,
                   const float* __restrict__ weight,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ fx_p,
                   const float* __restrict__ fy_p,
                   const float* __restrict__ cx_p,
                   const float* __restrict__ cy_p,
                   const float* __restrict__ bf_p,
                   float chi2_m, float chi2_s, float damping,
                   int outer_iters, int inner_iters, int N,
                   float* __restrict__ T_out,
                   uint8_t* __restrict__ inlier_out,
                   int* __restrict__ n_inl_out) {
  extern __shared__ float smem[];
  __shared__ float s_T[12];
  __shared__ float s_part[kWarps][kSums];
  __shared__ float s_tot[kSums];
  __shared__ int s_cnt[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* f_px = smem;
  float* f_py = smem + N;
  float* f_pz = smem + 2 * N;
  float* f_uo = smem + 3 * N;
  float* f_vo = smem + 4 * N;
  float* f_ro = smem + 5 * N;
  float* f_w2 = smem + 6 * N;
  uint8_t* s_msk = reinterpret_cast<uint8_t*>(smem + kFields * N);
  uint8_t* s_inl = s_msk + N;
  const Feats F{f_px, f_py, f_pz, f_uo, f_vo, f_ro, f_w2};

  const float fx = *fx_p, fy = *fy_p, cx = *cx_p, cy = *cy_p, bf = *bf_p;
  const float dh_m = sqrtf(chi2_m), dh_s = sqrtf(chi2_s);

  const size_t base = static_cast<size_t>(b) * N;
  for (int i = tid; i < N; i += kThreads) {
    const size_t g = base + i;
    f_px[i] = points[3 * g];
    f_py[i] = points[3 * g + 1];
    f_pz[i] = points[3 * g + 2];
    f_uo[i] = uv[2 * g];
    f_vo[i] = uv[2 * g + 1];
    f_ro[i] = right[g];
    const float w = weight[g];
    f_w2[i] = w * w;
    const uint8_t m = mask[g] != 0;
    s_msk[i] = m;
    s_inl[i] = m;
  }
  if (tid < 12) s_T[tid] = T_init[static_cast<size_t>(b) * 16 + tid];
  __syncthreads();

  for (int o = 0; o < outer_iters; ++o) {
    for (int it = 0; it < inner_iters; ++it) {
      float T[12];
      for (int k = 0; k < 12; ++k) T[k] = s_T[k];
      float acc[kSums];
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
      for (int i = tid; i < N; i += kThreads) {
        const Residual r = residual(F, i, T, fx, fy, cx, cy, bf);
        const float X = r.X, Y = r.Y, Z = r.Z, iz = r.iz;
        const float iz2 = iz * iz;
        const float e = sqrtf(r.chi2 + 1e-12f);
        const float huber = fminf(1.0f, (r.stereo ? dh_s : dh_m) / e);
        const float wt =
            (s_msk[i] && r.z_ok && s_inl[i]) ? f_w2[i] * huber : 0.0f;
        const float sflag = r.stereo ? 1.0f : 0.0f;
        const float j0[6] = {fx * iz, 0.0f, -fx * X * iz2, -fx * X * Y * iz2,
                             fx * Z * iz + fx * X * X * iz2, -fx * Y * iz};
        const float j1[6] = {0.0f, fy * iz, -fy * Y * iz2,
                             -fy * Z * iz - fy * Y * Y * iz2, fy * X * Y * iz2,
                             fy * X * iz};
        const float j2[6] = {sflag * (fx * iz), 0.0f,
                             sflag * ((bf - fx * X) * iz2),
                             sflag * ((bf - fx * X) * Y * iz2),
                             sflag * (fx * Z * iz + (fx * X - bf) * X * iz2),
                             sflag * (-fx * Y * iz)};
        int k = 0;
        for (int p = 0; p < 6; ++p)
          for (int q = p; q < 6; ++q)
            acc[k++] += wt * (j0[p] * j0[q] + j1[p] * j1[q] + j2[p] * j2[q]);
        for (int p = 0; p < 6; ++p)
          acc[21 + p] += wt * (j0[p] * r.ru + j1[p] * r.rv + j2[p] * r.rr);
      }
      // fixed-order block reduction: warp shuffles, one partial per warp
      // in shared memory, then warp 0 sums the partials in warp order
      for (int k = 0; k < kSums; ++k) acc[k] = warp_sum(acc[k]);
      if (lane == 0)
        for (int k = 0; k < kSums; ++k) s_part[warp][k] = acc[k];
      __syncthreads();
      if (tid < kSums) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s += s_part[w][tid];
        s_tot[tid] = s;
      }
      __syncthreads();
      if (tid == 0) {
        float H[6][6], rhs[6], d[6];
        int k = 0;
        for (int p = 0; p < 6; ++p)
          for (int q = p; q < 6; ++q) {
            H[p][q] = s_tot[k];
            H[q][p] = s_tot[k];
            ++k;
          }
        for (int p = 0; p < 6; ++p) {
          H[p][p] += damping;
          rhs[p] = s_tot[21 + p];
        }
        solve6(H, rhs, d);
        const float v[3] = {-d[0], -d[1], -d[2]};
        const float w[3] = {-d[3], -d[4], -d[5]};
        float Rd[3][3], td[3];
        se3_exp(v, w, Rd, td);
        float Tn[12];
        for (int r = 0; r < 3; ++r) {
          for (int c = 0; c < 3; ++c)
            Tn[4 * r + c] = Rd[r][0] * T[c] + Rd[r][1] * T[4 + c] +
                            Rd[r][2] * T[8 + c];
          Tn[4 * r + 3] = Rd[r][0] * T[3] + Rd[r][1] * T[7] +
                          Rd[r][2] * T[11] + td[r];
        }
        for (int q = 0; q < 12; ++q) s_T[q] = Tn[q];
      }
      __syncthreads();
    }
    // chi2 reclassification against the refined pose
    float T[12];
    for (int k = 0; k < 12; ++k) T[k] = s_T[k];
    for (int i = tid; i < N; i += kThreads) {
      const Residual r = residual(F, i, T, fx, fy, cx, cy, bf);
      const float th = r.stereo ? chi2_s : chi2_m;
      s_inl[i] = (s_msk[i] && r.z_ok && r.chi2 <= th) ? 1 : 0;
    }
    __syncthreads();
  }

  int cnt = 0;
  for (int i = tid; i < N; i += kThreads) {
    const uint8_t f = s_inl[i];
    inlier_out[base + i] = f;
    cnt += f;
  }
  cnt = warp_sum_int(cnt);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
    n_inl_out[b] = total;
    // column-wise modified Gram-Schmidt on the rotation block
    float c0[3] = {s_T[0], s_T[4], s_T[8]};
    float c1[3] = {s_T[1], s_T[5], s_T[9]};
    const float n0 = rsqrtf(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2] + 1e-30f);
    for (int r = 0; r < 3; ++r) c0[r] *= n0;
    const float dp = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
    for (int r = 0; r < 3; ++r) c1[r] -= dp * c0[r];
    const float n1 = rsqrtf(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2] + 1e-30f);
    for (int r = 0; r < 3; ++r) c1[r] *= n1;
    const float c2[3] = {c0[1] * c1[2] - c0[2] * c1[1],
                         c0[2] * c1[0] - c0[0] * c1[2],
                         c0[0] * c1[1] - c0[1] * c1[0]};
    float* out = T_out + static_cast<size_t>(b) * 16;
    for (int r = 0; r < 3; ++r) {
      out[4 * r + 0] = c0[r];
      out[4 * r + 1] = c1[r];
      out[4 * r + 2] = c2[r];
      out[4 * r + 3] = s_T[4 * r + 3];
    }
    out[12] = 0.0f; out[13] = 0.0f; out[14] = 0.0f; out[15] = 1.0f;
  }
}

}  // namespace

extern "C" int snk_pose_refine_fused(
    const void* T_init, const void* points, const void* uv, const void* right,
    const void* weight, const void* mask, const void* fx, const void* fy,
    const void* cx, const void* cy, const void* bf, float chi2_mono,
    float chi2_stereo, float damping, int outer_iters, int inner_iters, int B,
    int N, void* T_out, void* inlier_out, void* n_inl_out, void* stream) {
  const size_t smem = static_cast<size_t>(N) * (kFields * sizeof(float) + 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pose_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pose_refine_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T_init), static_cast<const float*>(points),
      static_cast<const float*>(uv), static_cast<const float*>(right),
      static_cast<const float*>(weight), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(cx), static_cast<const float*>(cy),
      static_cast<const float*>(bf), chi2_mono, chi2_stereo, damping,
      outer_iters, inner_iters, N, static_cast<float*>(T_out),
      static_cast<uint8_t*>(inlier_out), static_cast<int*>(n_inl_out));
  return static_cast<int>(cudaGetLastError());
}
