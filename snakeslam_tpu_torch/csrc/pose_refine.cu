// Fused robust pose refine: a whole robust Gauss-Newton pose solve in one
// launch, one thread-block cluster per problem.
//
// Replaces the TPU kernel snakeslam_tpu/ops/pose_pallas.py
// (pose_refine_fused, kernel body _pose_refine_kernel).  Same semantics:
//   * outer_iters rounds of (inner_iters damped GN steps -> chi2
//     reclassification of the inliers);
//   * Huber weights at sqrt(chi2 + 1e-12) against the mono / stereo pixel
//     thresholds, depth gate Z > 1e-4;
//   * 21 H sums plus 6 b sums per GN step, damping on the diagonal, a
//     closed-form 3x3-block Schur solve, left-multiplied SE3 exponential
//     with the Taylor switch at theta < 1e-4;
//   * the hat-block Jacobian terms use the raw Z, not the clamped one; the
//     stereo third row is scaled by the stereo flag;
//   * the rotation is re-orthonormalized by column-wise Gram-Schmidt at the
//     end, not between steps.
//
// What bounds it on Hopper: latency.  One problem of N = 1024 features at
// (2, 2) iterations reads ~31 KB and does ~1.2 MFLOP: its roofline bound is
// ~18 ns (operations at 67 TFLOP/s f32; the bytes take ~9 ns at 3.35 TB/s).
// What it takes is a chain of dependent rounds: per GN step, a pass over
// the features, a reduction of 27 sums, a 6x6 solve and an exponential,
// and the next step needs the new pose.  The old design ran the whole
// problem on one SM and solved on one thread while the block waited.
//
// The design cuts every link of that chain:
//   * the features of a problem are spread over a cluster of C CTAs
//     (C = 8 of 128 threads at N = 1024; C and the CTA width follow N), one
//     feature per thread, held in registers for the whole call and loaded
//     once with coalesced loads; larger N loops K features per thread;
//   * each warp reduces its 27 sums (padded to 32) by a transposed
//     butterfly: 31 shuffles, after which lane k holds sum k;
//   * lanes 0-26 of every warp push their sums into a double-buffered slot
//     of every CTA of the cluster (st.async into distributed shared
//     memory), and each push completes its bytes on the receiving CTA's
//     transaction barrier (mbarrier); a CTA waits on its own barrier for
//     C x warps x 27 x 4 bytes.  No thread waits on one thread, and there
//     is no block or cluster barrier in a GN step: on an H100 a cluster
//     barrier per step followed by reads of the other CTAs' slots took
//     ~2 us more per launch at N = 1024, (2, 2);
//   * every warp of every CTA then sums the C x warps partials in one
//     fixed order from its own shared memory and solves the same 6x6
//     system itself, so every warp computes the bit-identical pose with no
//     broadcast, and reruns are bit-identical.  Double buffering lets a
//     CTA push step s + 1 while a slower one still reads step s;
//   * the solve takes one reciprocal per determinant and one sincosf, and
//     gets the 27 totals by shuffles;
//   * the chi2 reclassification of round o is fused into the first GN pass
//     of round o + 1, which computes the same residual against the same
//     pose; only the last round's reclassification is a pass of its own;
//   * every CTA writes its own features' inlier bytes and pushes its warps'
//     inlier counts to rank 0, which sums them in order and writes the
//     count and the pose.  A CTA exits once everything pushed to it has
//     landed, so none is written to after it exits.
// N is any size up to 2048 features a CTA (16384 at C = 8); ragged tails
// are masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpose_refine.so pose_refine.cu
// Bound with ctypes (snakeslam_tpu_torch/ops/pose_fused.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;        // above 8 needs the non-portable opt-in
constexpr int kMaxPerCta = 2048;       // 8 features a thread x 256 threads
constexpr int kMaxParts = 64;          // CTAs x warps of one cluster
constexpr int kSums = 27;              // 21 upper-triangle H entries + 6 b

struct Params {
  const float* T_init; const float* points; const float* uv;
  const float* right; const float* weight; const uint8_t* mask;
  const float* fx; const float* fy; const float* cx; const float* cy;
  const float* bf;
  float chi2_m, chi2_s, damping;
  int outer_iters, inner_iters, N, C, per_cta;
  float* T_out; uint8_t* inlier_out; int* n_inl_out;
};

struct Cam { float fx, fy, cx, cy, bf; };

// one feature, in registers for the whole call
struct Feat {
  float px, py, pz, uo, vo, ro, w2;
  bool msk, inl, live;
};

struct Residual {
  float X, Y, Z, iz, ru, rv, rr, chi2;
  bool z_ok, stereo;
};

__device__ __forceinline__ Residual residual(const Feat& f, const float T[12],
                                             const Cam& cam) {
  Residual r;
  r.X = T[0] * f.px + T[1] * f.py + T[2] * f.pz + T[3];
  r.Y = T[4] * f.px + T[5] * f.py + T[6] * f.pz + T[7];
  r.Z = T[8] * f.px + T[9] * f.py + T[10] * f.pz + T[11];
  r.z_ok = r.Z > 1e-4f;
  const float zs = r.z_ok ? r.Z : 1.0f;
  r.iz = 1.0f / zs;
  const float u = cam.fx * r.X * r.iz + cam.cx;
  const float v = cam.fy * r.Y * r.iz + cam.cy;
  r.stereo = f.ro > 0.0f;
  r.ru = u - f.uo;
  r.rv = v - f.vo;
  r.rr = r.stereo ? u - cam.bf * r.iz - f.ro : 0.0f;
  r.chi2 = f.w2 * (r.ru * r.ru + r.rv * r.rv + r.rr * r.rr);
  return r;
}

// Adds one feature's weighted normal-equation terms to acc[0..26] (21
// upper-triangle H entries, then 6 b entries); when
// ``reclass``, first reclassifies the feature against the same residual
// (the previous round's chi2 test, fused into this pass).
__device__ __forceinline__ void accumulate(Feat& f, const float T[12],
                                           const Cam& cam, bool reclass,
                                           float chi2_m, float chi2_s,
                                           float dh_m, float dh_s,
                                           float acc[32]) {
  const Residual r = residual(f, T, cam);
  if (reclass)
    f.inl = f.msk && r.z_ok && r.chi2 <= (r.stereo ? chi2_s : chi2_m);
  const float fx = cam.fx, fy = cam.fy, bf = cam.bf;
  const float X = r.X, Y = r.Y, Z = r.Z, iz = r.iz;
  const float iz2 = iz * iz;
  const float e = sqrtf(r.chi2 + 1e-12f);
  const float huber = fminf(1.0f, (r.stereo ? dh_s : dh_m) / e);
  const float wt = (f.msk && r.z_ok && f.inl) ? f.w2 * huber : 0.0f;
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
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q)
      acc[k++] += wt * (j0[p] * j0[q] + j1[p] * j1[q] + j2[p] * j2[q]);
#pragma unroll
  for (int p = 0; p < 6; ++p)
    acc[21 + p] += wt * (j0[p] * r.ru + j1[p] * r.rv + j2[p] * r.rr);
}

// Transposed butterfly: sums v[k] over the warp for all 32 k at once with
// 16 + 8 + 4 + 2 + 1 = 31 shuffles.  Each stage halves the values a lane
// keeps and swaps the other half with its partner; afterwards lane k holds
// the warp's sum of v[k].  The order is fixed, so the result is too.
template <int kHalf>
__device__ __forceinline__ void butterfly_stage(float v[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, kHalf);
  }
}

__device__ __forceinline__ float transpose_reduce(float v[32], int lane) {
  butterfly_stage<16>(v, lane);
  butterfly_stage<8>(v, lane);
  butterfly_stage<4>(v, lane);
  butterfly_stage<2>(v, lane);
  butterfly_stage<1>(v, lane);
  return v[0];
}

// closed-form 3x3 inverse via the adjugate (ops/linalg.inv3x3), with one
// reciprocal of the determinant
__device__ __forceinline__ void inv3(const float m[3][3], float out[3][3]) {
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
  const float rd = 1.0f / det;
  out[0][0] = A11 * rd; out[0][1] = A12 * rd; out[0][2] = A13 * rd;
  out[1][0] = A21 * rd; out[1][1] = A22 * rd; out[1][2] = A23 * rd;
  out[2][0] = A31 * rd; out[2][1] = A32 * rd; out[2][2] = A33 * rd;
}

// 6x6 PSD solve by 3x3 block Schur elimination: H = [[A, B], [B^T, D]]
__device__ __forceinline__ void solve6(const float H[6][6], const float rhs[6],
                                       float x[6]) {
  float A[3][3], B[3][3], D[3][3], Ai[3][3], BtAi[3][3], S[3][3], Si[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A[r][c] = H[r][c];
      B[r][c] = H[r][c + 3];
      D[r][c] = H[r + 3][c + 3];
    }
  inv3(A, Ai);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      BtAi[r][c] = B[0][r] * Ai[0][c] + B[1][r] * Ai[1][c] + B[2][r] * Ai[2][c];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      S[r][c] = D[r][c] - (BtAi[r][0] * B[0][c] + BtAi[r][1] * B[1][c] +
                           BtAi[r][2] * B[2][c]);
  float rhs2[3], rhs1[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    rhs2[r] = rhs[3 + r] - (BtAi[r][0] * rhs[0] + BtAi[r][1] * rhs[1] +
                            BtAi[r][2] * rhs[2]);
  inv3(S, Si);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    x[3 + r] = Si[r][0] * rhs2[0] + Si[r][1] * rhs2[1] + Si[r][2] * rhs2[2];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    rhs1[r] = rhs[r] - (B[r][0] * x[3] + B[r][1] * x[4] + B[r][2] * x[5]);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    x[r] = Ai[r][0] * rhs1[0] + Ai[r][1] * rhs1[1] + Ai[r][2] * rhs1[2];
}

// SE3 exponential, Sophus ordering (upsilon v, omega w) -> R, t
__device__ __forceinline__ void se3_exp(const float v[3], const float w[3],
                                        float R[3][3], float t[3]) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(th2 + 1e-30f);
  const bool small = th < 1e-4f;
  float s, c;
  sincosf(th, &s, &c);
  const float a = small ? 1.0f - th2 / 6.0f : s / th;
  const float bb = small ? 0.5f - th2 / 24.0f : (1.0f - c) / (th2 + 1e-30f);
  const float cc = small ? 1.0f / 6.0f - th2 / 120.0f
                         : (th - s) / (th2 * th + 1e-30f);
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]},
                         {-w[1], w[0], 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      W2[r][k] = W[r][0] * W[0][k] + W[r][1] * W[1][k] + W[r][2] * W[2][k];
  float V[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float e = (r == k) ? 1.0f : 0.0f;
      R[r][k] = e + a * W[r][k] + bb * W2[r][k];
      V[r][k] = e + bb * W[r][k] + cc * W2[r][k];
    }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    t[r] = V[r][0] * v[0] + V[r][1] * v[1] + V[r][2] * v[2];
}

// One GN update from the 27 totals (lane k holds total k): every lane of
// the warp solves the same system and composes the same pose into T.
__device__ __forceinline__ void gn_update(float tot, float damping,
                                          float T[12]) {
  float H[6][6], rhs[6], d[6];
  int k = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) {
      const float h = __shfl_sync(kFull, tot, k++);
      H[p][q] = h;
      H[q][p] = h;
    }
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    H[p][p] += damping;
    rhs[p] = __shfl_sync(kFull, tot, 21 + p);
  }
  solve6(H, rhs, d);
  const float v[3] = {-d[0], -d[1], -d[2]};
  const float w[3] = {-d[3], -d[4], -d[5]};
  float Rd[3][3], td[3];
  se3_exp(v, w, Rd, td);
  float Tn[12];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Tn[4 * r + c] = Rd[r][0] * T[c] + Rd[r][1] * T[4 + c] +
                      Rd[r][2] * T[8 + c];
    Tn[4 * r + 3] = Rd[r][0] * T[3] + Rd[r][1] * T[7] + Rd[r][2] * T[11] +
                    td[r];
  }
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = Tn[q];
}

// shared::cta address of a shared-memory object
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// the shared::cluster address of the same object in CTA ``rank``
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also expects ``bytes`` of pushed data this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of ``parity`` completes (all bytes have landed)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// store 4 bytes into (remote) shared memory; the store completes its bytes
// on the destination CTA's barrier
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t value,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n"
      :: "r"(addr), "r"(value), "r"(bar) : "memory");
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
pose_refine_kernel(const Params p) {
  // s_slot[buf][part][k]: partial sum k of part = (source rank, warp), as
  // every warp of the cluster pushes it; s_bar[buf] counts its bytes in
  __shared__ float s_slot[2][kMaxParts][32];
  __shared__ uint32_t s_cnt[kMaxParts];     // rank 0: inlier counts a warp
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ __align__(8) uint64_t s_bar_cnt;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C;
  const unsigned rank = cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int n_parts = C * nwarps;
  const int N = p.N;
  const int first = static_cast<int>(rank) * p.per_cta;
  const int end = min(N, first + p.per_cta);
  const size_t base = static_cast<size_t>(b) * N;

  if (tid == 0) {
    mbar_init(smem_u32(&s_bar[0]), 1);
    mbar_init(smem_u32(&s_bar[1]), 1);
    mbar_init(smem_u32(&s_bar_cnt), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  Feat f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = first + k * nthreads + tid;
    f[k].live = i < end;
    if (f[k].live) {
      const size_t g = base + i;
      f[k].px = p.points[3 * g];
      f[k].py = p.points[3 * g + 1];
      f[k].pz = p.points[3 * g + 2];
      f[k].uo = p.uv[2 * g];
      f[k].vo = p.uv[2 * g + 1];
      f[k].ro = p.right[g];
      const float w = p.weight[g];
      f[k].w2 = w * w;
      f[k].msk = p.mask[g] != 0;
    } else {
      f[k].px = f[k].py = f[k].pz = f[k].uo = f[k].vo = f[k].ro = 0.0f;
      f[k].w2 = 0.0f;
      f[k].msk = false;
    }
    f[k].inl = f[k].msk;
  }
  float T[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = p.T_init[static_cast<size_t>(b) * 16 + q];
  const Cam cam{*p.fx, *p.fy, *p.cx, *p.cy, *p.bf};
  const float chi2_m = p.chi2_m, chi2_s = p.chi2_s;
  const float dh_m = sqrtf(chi2_m), dh_s = sqrtf(chi2_s);
  // every CTA's barriers are initialized before anyone pushes into them
  cluster.sync();

  const uint32_t step_bytes = static_cast<uint32_t>(n_parts * kSums * 4);
  int buf = 0;
  uint32_t parity = 0;  // bit buf: the phase of s_bar[buf] to wait for
  for (int o = 0; o < p.outer_iters; ++o) {
    for (int it = 0; it < p.inner_iters; ++it) {
      const bool reclass = o > 0 && it == 0;
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (f[k].live)
          accumulate(f[k], T, cam, reclass, chi2_m, chi2_s, dh_m, dh_s, acc);
      const float part = transpose_reduce(acc, lane);
      const uint32_t bar = smem_u32(&s_bar[buf]);
      if (tid == 0) mbar_expect_tx(bar, step_bytes);
      // push this warp's 27 partials into its slot of every CTA
      if (lane < kSums) {
        const uint32_t slot =
            smem_u32(&s_slot[buf][static_cast<int>(rank) * nwarps + warp][lane]);
        for (int r = 0; r < C; ++r)
          st_async(mapa(slot, r), __float_as_uint(part), mapa(bar, r));
      }
      mbar_wait(bar, (parity >> buf) & 1u);
      parity ^= 1u << buf;
      // every warp sums the parts in (rank, warp) order and solves
      float tot = 0.0f;
      if (lane < kSums) {
        tot = s_slot[buf][0][lane];
        for (int q = 1; q < n_parts; ++q) tot += s_slot[buf][q][lane];
      }
      buf ^= 1;
      gn_update(tot, p.damping, T);
    }
  }

  // the last round's chi2 reclassification against the refined pose
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!f[k].live) continue;
    if (p.outer_iters > 0) {
      const Residual r = residual(f[k], T, cam);
      f[k].inl =
          f[k].msk && r.z_ok && r.chi2 <= (r.stereo ? chi2_s : chi2_m);
    }
    p.inlier_out[base + first + k * nthreads + tid] = f[k].inl ? 1 : 0;
    cnt += f[k].inl ? 1 : 0;
  }
  cnt = __reduce_add_sync(kFull, cnt);
  // every warp pushes its count to rank 0, which sums them in order; the
  // other CTAs have received everything pushed to them and may exit
  const uint32_t cbar = smem_u32(&s_bar_cnt);
  if (rank == 0 && tid == 0)
    mbar_expect_tx(cbar, static_cast<uint32_t>(n_parts * 4));
  if (lane == 0)
    st_async(mapa(smem_u32(&s_cnt[static_cast<int>(rank) * nwarps + warp]), 0),
             static_cast<uint32_t>(cnt), mapa(cbar, 0));
  if (rank == 0 && tid == 0) {
    mbar_wait(cbar, 0);
    int total = 0;
    for (int q = 0; q < n_parts; ++q) total += static_cast<int>(s_cnt[q]);
    p.n_inl_out[b] = total;
    // column-wise modified Gram-Schmidt on the rotation block
    float c0[3] = {T[0], T[4], T[8]};
    float c1[3] = {T[1], T[5], T[9]};
    const float n0 =
        rsqrtf(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2] + 1e-30f);
    for (int r = 0; r < 3; ++r) c0[r] *= n0;
    const float dp = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
    for (int r = 0; r < 3; ++r) c1[r] -= dp * c0[r];
    const float n1 =
        rsqrtf(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2] + 1e-30f);
    for (int r = 0; r < 3; ++r) c1[r] *= n1;
    const float c2[3] = {c0[1] * c1[2] - c0[2] * c1[1],
                         c0[2] * c1[0] - c0[0] * c1[2],
                         c0[0] * c1[1] - c0[1] * c1[0]};
    float* out = p.T_out + static_cast<size_t>(b) * 16;
    for (int r = 0; r < 3; ++r) {
      out[4 * r + 0] = c0[r];
      out[4 * r + 1] = c1[r];
      out[4 * r + 2] = c2[r];
      out[4 * r + 3] = T[4 * r + 3];
    }
    out[12] = 0.0f; out[13] = 0.0f; out[14] = 0.0f; out[15] = 1.0f;
  }
}

template <int K>
cudaError_t launch(const Params& p, int B, int threads, cudaStream_t stream) {
  if (p.C > kPortableCluster) {
    const cudaError_t e = cudaFuncSetAttribute(
        pose_refine_kernel<K>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * p.C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pose_refine_kernel<K>, p);
}

}  // namespace

// T_init (B, 4, 4), points (B, N, 3), uv (B, N, 2), right / weight (B, N)
// float32, mask (B, N) bytes, the five camera scalars as device pointers;
// outputs T_out (B, 4, 4) float32, inlier_out (B, N) bytes, n_inl_out (B,)
// int32; all contiguous on the device.  ``cluster`` is the number of CTAs
// a problem is spread over (0: derived from N).  Launches on ``stream`` and
// returns the launch's cudaError_t (0 on success); does not synchronize.
extern "C" int snk_pose_refine_fused(
    const void* T_init, const void* points, const void* uv, const void* right,
    const void* weight, const void* mask, const void* fx, const void* fy,
    const void* cx, const void* cy, const void* bf, float chi2_mono,
    float chi2_stereo, float damping, int outer_iters, int inner_iters, int B,
    int N, int cluster, void* T_out, void* inlier_out, void* n_inl_out,
    void* stream) {
  if (B == 0) return 0;
  if (N < 0 || cluster < 0 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = cluster > 0 ? cluster
                            : (N <= 128 ? 1
                                        : (N + 127) / 128 < kPortableCluster
                                              ? (N + 127) / 128
                                              : kPortableCluster);
  const int per_cta = (N + C - 1) / C;
  if (per_cta > kMaxPerCta) return static_cast<int>(cudaErrorInvalidValue);
  // features a thread: the smallest of 1, 2, 4, 8 that keeps the CTA at
  // 128 threads, then up to 256 threads at 8
  int K = 1;
  while (K < 8 && per_cta > 128 * K) K *= 2;
  int threads = ((per_cta + K - 1) / K + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (C * (threads / 32) > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(T_init),
                 static_cast<const float*>(points),
                 static_cast<const float*>(uv),
                 static_cast<const float*>(right),
                 static_cast<const float*>(weight),
                 static_cast<const uint8_t*>(mask),
                 static_cast<const float*>(fx), static_cast<const float*>(fy),
                 static_cast<const float*>(cx), static_cast<const float*>(cy),
                 static_cast<const float*>(bf),
                 chi2_mono, chi2_stereo, damping, outer_iters, inner_iters, N,
                 C, per_cta,
                 static_cast<float*>(T_out), static_cast<uint8_t*>(inlier_out),
                 static_cast<int*>(n_inl_out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (K) {
    case 1: e = launch<1>(p, B, threads, s); break;
    case 2: e = launch<2>(p, B, threads, s); break;
    case 4: e = launch<4>(p, B, threads, s); break;
    default: e = launch<8>(p, B, threads, s); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
