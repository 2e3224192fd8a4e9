// Device code shared by the fused SBV likelihood, prediction and
// multi-output stats kernels.
//
// Each kernel works on one packed block at a time, on an augmented
// covariance PANEL held in a device-memory scratch slice owned by the CTA:
//
//     rows    0 .. m-1      the m conditioning neighbours
//     rows    m .. P-1      the bs block (or query) points, P = m + bs
//     rows    P .. N-1      the observations (masked), one extra row per
//                           output: N = P + 1, or P + p for p outputs
//
// stored column-major with leading dimension N. Only the lower triangle
// (row >= column) of the first `ncols` columns is formed. A Cholesky over
// those columns then yields, in place,
//   * the factor of K(NN, NN) in columns < m,
//   * A^T = (L^-1 K(NN, B))^T in rows m..P-1 of columns < m,
//   * z^T = (L^-1 y_NN)^T in each observation row of columns < m,
// and, when ncols = P (likelihood, multi-output stats), the factor of the
// Schur complement K(B, B) - A^T A in the block rows and
// v = L'^-1 (y_B - mu) in each observation row. That is the Pallas kernels'
// chain chol -> joint solve -> Schur -> chol -> solve, done as one
// elimination over the joint matrix.
//
// Two cores do that elimination. The earlier one (`load_points`,
// `assemble`, `panel_cholesky`) keeps the padded layout above and factors
// right-looking in 16-column panels; the kernels' `_panel` entry points
// keep it callable for side-by-side timings. The tiled core
// (`load_points_compact`, `assemble_compact`, `tiled_cholesky`; see "the
// tiled core" below) leaves the masked points out, so m and P above become
// the block's real counts, and factors left-looking in 32-column panels on
// the tensor cores: every kernel's main route runs on it.
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

#include <stdint.h>

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

// `matern` with its constant divisions as multiplications by the rounded
// reciprocals (1/3, 1/15): within an ulp or two of `matern`, and the
// divisions were most of the assembly's f64 work. `poly_nodiv` is its
// polynomial factor, for callers that take exp(-r) another way.
template <typename T>
__device__ __forceinline__ T poly_nodiv(T r, int nu_code) {
  if (nu_code == 0) return T(1);
  if (nu_code == 1) return T(1) + r;
  if (nu_code == 2) return T(1) + r + r * r * T(1.0 / 3.0);
  return T(1) + r + T(0.4) * (r * r) + (r * r * r) * T(1.0 / 15.0);
}

template <typename T>
__device__ __forceinline__ T matern_nodiv(T r, int nu_code) {
  return poly_nodiv(r, nu_code) * exp(-r);
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

// ------------------------------------------------ the tiled core ----
//
// `tiled_cholesky` is the likelihood kernel's factorization: the same
// elimination as `panel_cholesky` (rows below ncols ride along as extra
// right-hand sides; every pivot clamped at `floor` before its square root),
// in another order, built for the H100:
//
// * Left-looking, in panels of kTileNB = 32 columns. Panel [j0, j0 + 32) is
//   formed once from the original columns minus the product of the
//   finished factor L[rows >= j0, 0:j0] with L[j0:j0+32, 0:j0]^T. The
//   factor is read from device memory once per panel and the trailing
//   matrix is never written back, where the right-looking `panel_cholesky`
//   reads and writes the whole trailing matrix once per 16-column panel.
// * That product is register-tiled: each warp owns 32 rows x 32 columns of
//   the panel (4 x 4 fragments of 8 x 8), the operands stream through
//   shared memory in chunks of kTileKC = 16 columns with `cp.async`, double
//   buffered, one barrier per chunk. In f64 the fragments are FP64
//   tensor-core products (`mma.sync.m16n8k8.f64`, DMMA, sm_90's shape); in
//   f32 the same fragments are FFMA register tiles (no TF32: it keeps ~3
//   decimal digits).
//   No per-element integer division.
// * The 32 x 32 diagonal tile is factored by one warp (lane i keeps row i
//   in shared memory and touches no other row; the pivot and the column go
//   by shuffles; each pivot is d * rsqrt(d), and the column is scaled by
//   rsqrt(d), so no division sits on the chain), then every row below it is
//   solved against it at once, one row per thread, with the tile's inverse
//   diagonal: three block-wide barriers per panel pass where
//   `panel_cholesky` takes two per column.
// * Each pass's accumulators start at minus the original panel entries, so
//   those loads land while the first chunk is staged.
//
// Rows go in passes of kTileRows = 256 (8 warps x 32 rows), so any number of
// rows fits the fixed register tile. A is column-major with leading
// dimension ld; only its lower triangle is read or written.
constexpr int kTileNB = 32;            // panel width
constexpr int kTileKC = 16;            // columns of the factor per staged chunk
constexpr int kTileRows = 256;         // rows per pass: 8 warps x 32
// Staged strides = 8 (mod 16) elements, so that the f64 fragment reads of a
// warp fall in two conflict-free wavefronts.
constexpr int kTileLdA = kTileRows + 8;
constexpr int kTileLdB = kTileNB + 8;
constexpr int kTileLdR = kTileNB + 1;  // row buffer / diagonal tile stride

// The factorization's shared memory, in elements of T from an 8-byte
// aligned base: two stages of the staged chunk (rows: As, panel rows: Bs),
// the row buffer of a pass (aliasing the stages), the diagonal tile and its
// inverse diagonal.
struct TileSmem {
  static constexpr int kA = 0;
  static constexpr int kB = 2 * kTileKC * kTileLdA;
  static constexpr int kRow = 0;
  static constexpr int kDiag = kB + 2 * kTileKC * kTileLdB;
  static constexpr int kDinv = kDiag + kTileNB * kTileLdR;
  static constexpr int kTotal = kDinv + kTileNB;
};
static_assert(kTileRows * kTileLdR <= TileSmem::kDiag, "the row buffer must fit in the stages");

// Shared memory of the kernels on the tiled core, in elements of T, for
// blocks of at most P points: beta (d), ys, nrm and the slots (P each),
// the block-sum scratch and the two counts, then the work region: the
// scaled coordinates (d x P) while the joint matrix is assembled, the
// factorization's buffers (TileSmem) after.
struct TiledLayout {
  int d, P;
  __host__ __device__ TiledLayout(int d_, int P_) : d(d_), P(P_) {}
  __host__ __device__ int beta() const { return 0; }
  __host__ __device__ int ys() const { return d; }
  __host__ __device__ int nrm() const { return d + P; }
  __host__ __device__ int slot() const { return d + 2 * P; }
  __host__ __device__ int red() const { return d + 3 * P; }
  __host__ __device__ int counts() const { return d + 3 * P + kThreads / 32; }
  __host__ __device__ int work() const { return (counts() + 2 + 1) & ~1; }
  __host__ __device__ int total() const {
    const int z = P * d;
    return work() + (z > TileSmem::kTotal ? z : TileSmem::kTotal);
  }
};
static_assert(kTileRows == 256 && kThreads == 256, "one row of a pass per thread");

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"((int)sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c (16 x 8, f64) += a (16 x 8) . b (8 x 8) on the FP64 tensor cores (sm_90's
// m16n8k8 shape). With g = lane / 4 and t = lane % 4, lane l holds
// a[g][t], a[g + 8][t], a[g][t + 4], a[g + 8][t + 4]; b[t][g], b[t + 4][g];
// c[g][2t], c[g][2t + 1], c[g + 8][2t], c[g + 8][2t + 1].
__device__ __forceinline__ void dmma_m16n8k8(double& c0, double& c1, double& c2, double& c3,
                                             double a0, double a1, double a2, double a3,
                                             double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// acc[rg][cg] (the warp's 8 x 8 fragment at row group rg, column group cg:
// rows rg * 8 + g, columns cg * 8 + 2t + {0, 1}) += staged rows . staged
// panel rows^T over one chunk of kTileKC columns. Only the first nrg row
// groups hold rows. In f64, row groups 2 rb and 2 rb + 1 are the two
// halves of one m16n8k8 product.
__device__ __forceinline__ void tile_update(double (&acc)[4][4][2], const double* As,
                                            const double* Bs, int warp, int lane, int nrg) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kTileKC / 8; ++ks) {
    double b0[4], b1[4];
#pragma unroll
    for (int cg = 0; cg < 4; ++cg) {
      b0[cg] = Bs[(ks * 8 + t) * kTileLdB + cg * 8 + g];
      b1[cg] = Bs[(ks * 8 + t + 4) * kTileLdB + cg * 8 + g];
    }
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      if (2 * rb < nrg) {
        const double* a = As + (ks * 8 + t) * kTileLdA + warp * 32 + rb * 16 + g;
        const double a0 = a[0], a1 = a[8], a2 = a[4 * kTileLdA], a3 = a[4 * kTileLdA + 8];
#pragma unroll
        for (int cg = 0; cg < 4; ++cg)
          dmma_m16n8k8(acc[2 * rb][cg][0], acc[2 * rb][cg][1], acc[2 * rb + 1][cg][0],
                       acc[2 * rb + 1][cg][1], a0, a1, a2, a3, b0[cg], b1[cg]);
      }
    }
  }
}

__device__ __forceinline__ void tile_update(float (&acc)[4][4][2], const float* As,
                                            const float* Bs, int warp, int lane, int nrg) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < kTileKC; ++k) {
    float2 b[4];
#pragma unroll
    for (int cg = 0; cg < 4; ++cg)
      b[cg] = *reinterpret_cast<const float2*>(Bs + k * kTileLdB + cg * 8 + 2 * t);
#pragma unroll
    for (int rg = 0; rg < 4; ++rg) {
      if (rg < nrg) {
        const float a = As[k * kTileLdA + warp * 32 + rg * 8 + g];
#pragma unroll
        for (int cg = 0; cg < 4; ++cg) {
          acc[rg][cg][0] = fmaf(a, b[cg].x, acc[rg][cg][0]);
          acc[rg][cg][1] = fmaf(a, b[cg].y, acc[rg][cg][1]);
        }
      }
    }
  }
}

__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }

template <typename T>
__device__ void tiled_cholesky(T* __restrict__ A, int ld, int nrows, int ncols, T floor,
                               T* work) {
  T* As = work + TileSmem::kA;
  T* Bs = work + TileSmem::kB;
  T* Rb = work + TileSmem::kRow;
  T* Dg = work + TileSmem::kDiag;
  T* Dinv = work + TileSmem::kDinv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int j0 = 0; j0 < ncols; j0 += kTileNB) {
    const int nb = min(kTileNB, ncols - j0);
    const int n_chunks = j0 / kTileKC;  // j0 is a multiple of kTileKC
    for (int r0 = j0; r0 < nrows; r0 += kTileRows) {
      const int rows = min(kTileRows, nrows - r0);
      const int nrg = max(0, min(4, (rows - warp * 32 + 7) / 8));

      // Stage chunk c of L[r0 : r0 + rows, :] and L[j0 : j0 + nb, :] into
      // stage c % 2 (zeros outside).
      auto stage = [&](int c) {
        const int kc = c * kTileKC;
        T* as = As + (c & 1) * kTileKC * kTileLdA;
        T* bs = Bs + (c & 1) * kTileKC * kTileLdB;
#pragma unroll 4
        for (int k = 0; k < kTileKC; ++k) {
          const bool ok = tid < rows;
          cp_async_elem(as + k * kTileLdA + tid, ok ? A + (size_t)(kc + k) * ld + r0 + tid : A, ok);
        }
#pragma unroll
        for (int q = 0; q < kTileKC * kTileNB / kThreads; ++q) {
          const int k = (tid >> 5) + q * (kThreads / 32), cc = tid & 31;
          const bool ok = cc < nb;
          cp_async_elem(bs + k * kTileLdB + cc, ok ? A + (size_t)(kc + k) * ld + j0 + cc : A, ok);
        }
        cp_async_commit();
      };

      // acc starts at minus the original panel entries (loads issued here,
      // clamped into range, landing while the first chunk is staged) and
      // gathers + L[rows, :j0] L[panel, :j0]^T: the panel is -acc.
      T acc[4][4][2];
#pragma unroll
      for (int rg = 0; rg < 4; ++rg) {
        const int i = min(r0 + warp * 32 + rg * 8 + g, nrows - 1);
#pragma unroll
        for (int cg = 0; cg < 4; ++cg)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = min(j0 + cg * 8 + 2 * t + e, ncols - 1);
            acc[rg][cg][e] = rg < nrg ? -A[(size_t)j * ld + i] : T(0);
          }
      }
      if (n_chunks > 0) stage(0);
      for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait_all();
        __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
        if (c + 1 < n_chunks) stage(c + 1);
        tile_update(acc, As + (c & 1) * kTileKC * kTileLdA, Bs + (c & 1) * kTileKC * kTileLdB,
                    warp, lane, nrg);
      }
      __syncthreads();  // the stages are free: the row buffer aliases them

      // The panel rows of this pass: original columns minus the update
      // (zero above the diagonal and right of the panel).
#pragma unroll
      for (int rg = 0; rg < 4; ++rg) {
        if (rg >= nrg) continue;
        const int lr = warp * 32 + rg * 8 + g;
        const int i = r0 + lr;
#pragma unroll
        for (int cg = 0; cg < 4; ++cg)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = cg * 8 + 2 * t + e;
            const bool ok = i < nrows && col < nb && i >= j0 + col;
            Rb[lr * kTileLdR + col] = ok ? -acc[rg][cg][e] : T(0);
          }
      }
      __syncthreads();

      if (r0 == j0) {
        // The diagonal tile, by warp 0: lane i keeps row i in shared memory
        // (identity past nb) and touches no other row; the pivot and the
        // column go between lanes by shuffles. Per column c: the pivot
        // d * rsqrt(d) (no division on the chain), the column scaled by
        // rsqrt(d), then the lane's row updated right of c in one unrolled,
        // predicated pass whose loads and stores are provably distinct, so
        // they overlap.
        if (warp == 0) {
          T* row = Dg + lane * kTileLdR;
#pragma unroll 4
          for (int c = 0; c < kTileNB; ++c)
            row[c] = (lane < nb && c < nb) ? Rb[lane * kTileLdR + c] : T(lane == c ? 1 : 0);
          for (int c = 0; c < kTileNB; ++c) {
            const T dd = fmax(__shfl_sync(0xffffffffu, row[c], c), floor);
            const T inv = rsqrt_t(dd);
            const T v = lane == c ? dd * inv : row[c] * inv;
            if (lane >= c) row[c] = v;
            if (lane == c) Dinv[c] = inv;
#pragma unroll
            for (int c2 = 1; c2 < kTileNB; ++c2) {
              const T l_c2 = __shfl_sync(0xffffffffu, v, c2);  // L[c2][c]
              if (c2 > c && c2 <= lane) row[c2] -= v * l_c2;
            }
          }
#pragma unroll 4
          for (int c = 0; c < kTileNB; ++c)
            if (c < nb && lane < nb && lane >= c) A[(size_t)(j0 + c) * ld + j0 + lane] = row[c];
        }
        __syncthreads();
      }

      // Every row below the diagonal tile, one per thread: x L_tile^T = row.
      {
        const int i = r0 + tid;
        if (tid < rows && i >= j0 + nb) {
          T x[kTileNB];
#pragma unroll
          for (int c = 0; c < kTileNB; ++c) x[c] = Rb[tid * kTileLdR + c];
#pragma unroll
          for (int c = 0; c < kTileNB; ++c) {
            T s = x[c];
#pragma unroll
            for (int k = 0; k < c; ++k) s -= x[k] * Dg[c * kTileLdR + k];
            x[c] = s * Dinv[c];
          }
#pragma unroll
          for (int c = 0; c < kTileNB; ++c)
            if (c < nb) A[(size_t)(j0 + c) * ld + i] = x[c];
        }
      }
      __syncthreads();  // the row buffer is consumed; the new columns are visible
    }
  }
}

// The point sets of one block with the masked points left out: set 0 (n0
// points) then set 1 (n1 points), compacted in order, so that point i of a
// set goes to slot[i] (counted from 0 in set 0 and from the number of real
// points of set 0 in set 1) or nowhere (slot -1). A masked point has zero
// covariance with every other point, a unit diagonal and y = 0, so it
// factors as an identity pivot that touches no other row: leaving it out
// changes no value of the real rows (and the pivot floor never reaches
// it). Scaled coordinates go to zt (d x ldz, transposed), observations to
// ys (ys null: none are staged; y0 and y1 are then not read), squared
// norms to nrm; n_real[0] gets the number of real points of set 0,
// n_real[1] that of both sets.
template <typename T, typename X>
__device__ void load_points_compact(const X* __restrict__ x0, const T* __restrict__ m0,
                                    const T* __restrict__ y0, int n0,
                                    const X* __restrict__ x1, const T* __restrict__ m1,
                                    const T* __restrict__ y1, int n1, int d, const T* beta,
                                    T* zt, int ldz, T* nrm, T* ys, int* slot, int* n_real) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const unsigned below = (1u << lane) - 1u;
    int run = 0;
    for (int base = 0; base < n0; base += 32) {
      const int i = base + lane;
      const bool real = i < n0 && m0[i] != T(0);
      const unsigned bits = __ballot_sync(0xffffffffu, real);
      if (i < n0) slot[i] = real ? run + __popc(bits & below) : -1;
      run += __popc(bits);
    }
    const int real0 = run;
    for (int base = 0; base < n1; base += 32) {
      const int i = base + lane;
      const bool real = i < n1 && m1[i] != T(0);
      const unsigned bits = __ballot_sync(0xffffffffu, real);
      if (i < n1) slot[n0 + i] = real ? run + __popc(bits & below) : -1;
      run += __popc(bits);
    }
    if (lane == 0) {
      n_real[0] = real0;
      n_real[1] = run;
    }
  }
  __syncthreads();
  const int P = n0 + n1;
  for (int e = threadIdx.x; e < P * d; e += blockDim.x) {
    const int i = e / d, k = e % d;
    const int s = slot[i];
    if (s < 0) continue;
    const X x = i < n0 ? x0[(size_t)i * d + k] : x1[(size_t)(i - n0) * d + k];
    zt[k * ldz + s] = Coords<X, T>::scale(x, beta[k]);
  }
  for (int i = threadIdx.x; ys && i < P; i += blockDim.x) {
    const int s = slot[i];
    if (s >= 0) ys[s] = i < n0 ? y0[i] : (y1 ? y1[i - n0] : T(0));
  }
  __syncthreads();
  const int pc = n_real[1];
  for (int s = threadIdx.x; s < pc; s += blockDim.x) {
    T v = T(0);
    for (int k = 0; k < d; ++k) v += zt[k * ldz + s] * zt[k * ldz + s];
    nrm[s] = v;
  }
  __syncthreads();
}

// The lower triangle of the first ncols columns of the compacted joint
// matrix: the covariance of the pc real points in rows < pc and, unless ys
// is null, the observations ys in row pc (a caller with several
// observation rows writes them itself). One warp per column, its lanes
// down the rows (no index division); the row loop is unrolled so that each
// lane runs several independent f64 chains (distance, sqrt, exp) at once.
template <typename T>
__device__ void assemble_compact(T* __restrict__ A, int ld, int pc, int ncols, int d,
                                 const T* zt, int ldz, const T* nrm, const T* ys, T sigma2,
                                 T nugget, int nu_code) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = ys ? pc : pc - 1;
  for (int j = warp; j < ncols; j += blockDim.x >> 5) {
#pragma unroll 4
    for (int i = j + lane; i <= last; i += 32) {
      T v;
      if (i == pc) {
        v = ys[j];
      } else {
        T dot = T(0);
        for (int k = 0; k < d; ++k) dot += zt[k * ldz + i] * zt[k * ldz + j];
        const T d2 = nrm[i] + nrm[j] - T(2) * dot;
        const T r = sqrt(fmax(d2, T(0)) + T(1e-30));
        v = sigma2 * matern_nodiv(r, nu_code);
        if (i == j) v += nugget;
      }
      A[(size_t)j * ld + i] = v;
    }
  }
  __syncthreads();
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
