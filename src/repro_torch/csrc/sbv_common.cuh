// Device code shared by the fused SBV likelihood and prediction kernels.
//
// Both kernels work on one packed block at a time, on an augmented
// covariance PANEL held in a device-memory scratch slice owned by the CTA:
//
//     rows    0 .. m-1      the m conditioning neighbours
//     rows    m .. P-1      the bs block (or query) points, P = m + bs
//     rows    P .. N-1      the observations (masked), one extra row per
//                           output: N = P + 1, or P + p for p outputs
//
// stored column-major with leading dimension N. Only the lower triangle
// (row >= column) of the first `ncols` columns is formed. A right-looking
// Cholesky over those columns then yields, in place,
//   * the factor of K(NN, NN) in columns < m,
//   * A^T = (L^-1 K(NN, B))^T in rows m..P-1 of columns < m,
//   * z^T = (L^-1 y_NN)^T in each observation row of columns < m,
// and, when ncols = P (likelihood, multi-output stats), the factor of the
// Schur complement K(B, B) - A^T A in the block rows and
// v = L'^-1 (y_B - mu) in each observation row. That is the Pallas kernels'
// chain chol -> joint solve -> Schur -> chol -> solve, done as one
// elimination over the joint matrix.
//
// Identity padding: a masked point has zero covariance with every other
// point, a unit diagonal and y = 0, so it factors as the identity with no
// branch. The sqrt floor (1e-30 on the clamped squared distance) and the
// pivot floor (1e-30) are those of `_masked_cov_tile` / `_cholesky_inplace`
// in the Pallas kernel.
//
// Coordinates may be stored narrower than the working type T: bf16
// coordinates with T = float are the precision ladder's bf16-assembly tier
// (`narrow_gemm` in the Pallas kernels). There beta is rounded to bf16, the
// scaled coordinate z = x / beta is rounded to bf16 (see Coords), z is
// widened to f32 exactly, and everything after it runs in f32, with the
// Cholesky pivots clamped at eps(bf16) * sigma2 = 2^-7 * sigma2
// (pivot_floor). Masked pivots are exactly 1, above that floor for any
// sigma2 < 128, as in the Pallas kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace sbv {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kPanel = 16;     // columns factored per panel (blocked right-looking)

// How a stored coordinate of type X becomes a scaled coordinate of type T.
template <typename X, typename T>
struct Coords {
  static_assert(std::is_same<X, T>::value, "coordinates narrower than T: bf16 with float only");
  static __device__ __forceinline__ T beta(T b) { return b; }
  static __device__ __forceinline__ T scale(X x, T b) { return x / b; }
};

// bf16 assembly: z = bf16(x / bf16(beta)). The quotient is formed in f32
// (an IEEE-rounded division without fast math) and rounded to bf16 to
// nearest even; f32's 24 bits >= 2 * 8 + 2, so that double rounding gives
// the correctly rounded bf16 quotient.
template <>
struct Coords<__nv_bfloat16, float> {
  static __device__ __forceinline__ float beta(float b) {
    return __bfloat162float(__float2bfloat16_rn(b));
  }
  static __device__ __forceinline__ float scale(__nv_bfloat16 x, float b) {
    return __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) / b));
  }
};

// Cholesky pivot floor: 1e-30 when the coordinates are stored at the
// working width, eps(bf16) * sigma2 on the bf16-assembly tier (the Pallas
// kernels' `finfo(xb.dtype).eps * sigma2`), whose rounded Gram matrix can
// leave a Schur complement slightly indefinite.
template <typename X, typename T>
__device__ __forceinline__ T pivot_floor(T sigma2) {
  return std::is_same<X, T>::value ? T(1e-30) : sigma2 * T(0.0078125);
}

template <typename T>
__device__ __forceinline__ T matern(T r, int nu_code) {
  T poly;
  if (nu_code == 0) {
    poly = T(1);
  } else if (nu_code == 1) {
    poly = T(1) + r;
  } else if (nu_code == 2) {
    poly = T(1) + r + r * r / T(3);
  } else {
    poly = T(1) + r + T(0.4) * (r * r) + (r * r * r) / T(15);
  }
  return poly * exp(-r);
}

// Shared-memory layout, in elements of T (see smem_elems).
struct Smem {
  int d, P, N;
  __host__ __device__ Smem(int d_, int P_, int N_) : d(d_), P(P_), N(N_) {}
  __host__ __device__ int beta() const { return 0; }
  __host__ __device__ int msk() const { return d; }
  __host__ __device__ int ys() const { return d + P; }
  __host__ __device__ int nrm() const { return d + 2 * P; }
  __host__ __device__ int red() const { return d + 3 * P; }
  // The scaled coordinates (transposed, d x P) are needed only while the
  // panel is assembled; the factorization panel (kPanel x N) reuses them.
  __host__ __device__ int work() const { return d + 3 * P + 2 * (kThreads / 32); }
  __host__ __device__ int total() const {
    int z = P * d, pan = kPanel * N;
    return work() + (z > pan ? z : pan);
  }
};

// Load the two point sets of one block: set 0 (n0 points) then set 1
// (n1 points). Coordinates (stored as X) are scaled by beta (already passed
// through Coords<X, T>::beta), transposed into zt (d x P, type T); masks go
// to msk and masked single-output observations to ys (y1 may be null:
// zeros). With ys null no observation is staged: a multi-output kernel
// reads its p observation rows from device memory in `assemble`. bf16 rows
// are read one 2-byte element at a time, so an odd d needs no alignment.
template <typename T, typename X>
__device__ void load_points(const X* __restrict__ x0, const T* __restrict__ m0,
                            const T* __restrict__ y0, int n0,
                            const X* __restrict__ x1, const T* __restrict__ m1,
                            const T* __restrict__ y1, int n1, int d,
                            const T* beta, T* zt, T* nrm, T* msk, T* ys) {
  const int P = n0 + n1;
  for (int e = threadIdx.x; e < P * d; e += blockDim.x) {
    int i = e / d, k = e % d;
    X x = i < n0 ? x0[(size_t)i * d + k] : x1[(size_t)(i - n0) * d + k];
    zt[k * P + i] = Coords<X, T>::scale(x, beta[k]);
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    T mk = i < n0 ? m0[i] : m1[i - n0];
    msk[i] = mk;
    if (ys) {
      T y = i < n0 ? y0[i] : (y1 ? y1[i - n0] : T(0));
      ys[i] = y * mk;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    T s = T(0);
    for (int k = 0; k < d; ++k) s += zt[k * P + i] * zt[k * P + i];
    nrm[i] = s;
  }
  __syncthreads();
}

// Form the lower triangle of the first ncols columns of the augmented panel:
// the covariance of the P points in rows < P, and in row P + r, column j,
// the value obs(r, j) of observation row r at point j (masked by the caller).
template <typename T, typename Obs>
__device__ void assemble(T* __restrict__ A, int N, int P, int ncols, int d, const T* zt,
                         const T* nrm, const T* msk, Obs obs, T sigma2, T nugget,
                         int nu_code) {
  for (int e = threadIdx.x; e < N * ncols; e += blockDim.x) {
    int i = e % N, j = e / N;
    if (i < j) continue;
    T v;
    if (i >= P) {
      v = obs(i - P, j);
    } else {
      T dot = T(0);
      for (int k = 0; k < d; ++k) dot += zt[k * P + i] * zt[k * P + j];
      T d2 = nrm[i] + nrm[j] - T(2) * dot;
      T r = sqrt(fmax(d2, T(0)) + T(1e-30));
      v = sigma2 * matern(r, nu_code) * (msk[i] * msk[j]);
      if (i == j) v += nugget * msk[i] + (T(1) - msk[i]);
    }
    A[(size_t)j * N + i] = v;
  }
  __syncthreads();
}

// Blocked right-looking Cholesky of the first ncols columns of the N-row
// panel A (lower triangle, column-major, leading dimension N). Rows below
// ncols are carried along as extra right-hand sides (the forward solve).
// Each panel of kPanel columns is factored in shared memory (pan, kPanel x N)
// and then applied once to the trailing columns, so the trailing matrix in
// device memory is read and written once per panel, not once per column.
template <typename T>
__device__ void panel_cholesky(T* __restrict__ A, int N, int ncols, T* pan, T floor) {
  for (int j0 = 0; j0 < ncols; j0 += kPanel) {
    const int nb = min(kPanel, ncols - j0);
    const int w = N - j0;  // rows j0 .. N-1
    for (int e = threadIdx.x; e < nb * w; e += blockDim.x) {
      int c = e / w, i = j0 + e % w;
      pan[c * N + i] = A[(size_t)(j0 + c) * N + i];
    }
    __syncthreads();
    for (int c = 0; c < nb; ++c) {
      const int j = j0 + c;
      const T piv = sqrt(fmax(pan[c * N + j], floor));
      for (int i = j + 1 + threadIdx.x; i < N; i += blockDim.x) pan[c * N + i] /= piv;
      __syncthreads();
      if (threadIdx.x == 0) pan[c * N + j] = piv;
      // Update the remaining columns of this panel.
      const int wr = N - j - 1;
      for (int e = threadIdx.x; e < wr * (nb - c - 1); e += blockDim.x) {
        int cc = c + 1 + e / wr, i = j + 1 + e % wr;
        int k = j0 + cc;
        if (i >= k) pan[cc * N + i] -= pan[c * N + i] * pan[c * N + k];
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < nb * w; e += blockDim.x) {
      int c = e / w, i = j0 + e % w;
      if (i >= j0 + c) A[(size_t)(j0 + c) * N + i] = pan[c * N + i];
    }
    // Trailing update: columns k in [j0+nb, ncols), rows i in [k, N).
    const int t0 = j0 + nb;
    const int wt = N - t0, nc = ncols - t0;
    for (int e = threadIdx.x; e < wt * nc; e += blockDim.x) {
      int i = t0 + e % wt, k = t0 + e / wt;
      if (i < k) continue;
      T s = T(0);
      for (int c = 0; c < nb; ++c) s += pan[c * N + i] * pan[c * N + k];
      A[(size_t)k * N + i] -= s;
    }
    __syncthreads();
  }
}

// Sum of one value per thread over the CTA; every thread gets the result.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();
  return s;
}

}  // namespace sbv
