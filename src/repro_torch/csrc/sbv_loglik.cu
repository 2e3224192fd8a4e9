// Fused SBV block log-likelihood for Hopper (sm_90a): f64, f32, and bf16
// coordinates with f32 working type (the precision ladder's bf16-assembly
// tier; see sbv_common.cuh for its rounding and pivot floor).
//
// Replaces `sbv_loglik_pallas` / `_sbv_kernel` in src/repro/kernels/sbv_loglik.py
// (its `_cholesky_inplace` chain chol -> solve -> Schur -> chol -> solve).
// Per packed block: scaled distances -> Matern(nu) -> one Cholesky of the
// joint (m + bs) covariance with y as an extra row -> log-determinant of the
// block part + quadratic form -> one scalar.
//
// Bound on an H100: at the main path's shapes (m = 200, bs <= 340, f64) a
// block needs ~1e7 floating-point operations on its real points and reads
// ~25 KB of inputs, so the function is bound by operations (67 TFLOP/s on
// the FP64 tensor cores), not by bytes. The working set (~1.2 MB per padded
// block in f64) is far above the 227 KB of shared memory a CTA can use.
//
// `sbv_loglik_kernel` (the route of all three variants) does three things
// about that:
// * it leaves the masked (identity-padding) points out of the joint matrix
//   (sbv_common.cuh, `load_points_compact`): they factor as identity pivots
//   that touch no other row, so every value of the real rows is unchanged,
//   and the work falls from the padded (m + bs)^3 / 3 to the real one;
// * it factors with `tiled_cholesky` (sbv_common.cuh): left-looking 32-column
//   panels in a device-memory scratch slice per CTA, the panel update as
//   register-tiled FP64 tensor-core products (FFMA tiles in f32) fed through
//   shared memory by `cp.async`, the diagonal tile in one warp's registers
//   and one triangular solve for all rows below it;
// * its scratch traffic is the factor read once per panel, about
//   P^3 / (6 * 32) elements of P = the block's real points, where the
//   earlier design read and wrote the padded trailing matrix once per
//   16-column panel (P^3 / 96 in each direction).
// -Xptxas=-v: 128 registers per thread (two CTAs of 256 threads per SM,
// by launch bounds); spills 24 B stored / 120 B loaded in f64, none in
// f32, 4 / 8 B in the bf16 variant. Dynamic shared memory, in elements of
// T: d + 3 P + 10 + max(d P, 10816) (TiledLayout), 99,648 B in f64 at
// m = 200, bs = 340, d = 10 (49,824 B in f32).
//
// `sbv_loglik_panel_kernel` is the earlier design, kept callable through
// the `sbv_loglik_panel_*` entry points for a side-by-side timing: padded
// blocks, `panel_cholesky` (right-looking, 16-column panels, scalar FMA
// trailing update).
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launch (0 on success).
#include "sbv_common.cuh"

namespace {

constexpr double kLog2Pi = 1.8378770664093453;

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads)
sbv_loglik_panel_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
                        const X* __restrict__ blk_x, const T* __restrict__ blk_y,
                        const T* __restrict__ blk_m, const X* __restrict__ nn_x,
                        const T* __restrict__ nn_y, const T* __restrict__ nn_m,
                        T* __restrict__ out, T* __restrict__ scratch,
                        int bc, int bs, int m, int d, int nu_code) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = m + bs, N = P + 1;
  const sbv::Smem L(d, P, N);
  T* beta_s = sm + L.beta();
  T* msk = sm + L.msk();
  T* ys = sm + L.ys();
  T* nrm = sm + L.nrm();
  T* red = sm + L.red();
  T* work = sm + L.work();
  T* A = scratch + (size_t)blockIdx.x * N * P;
  const T sigma2 = scal[0], nugget = scal[1];
  const T piv_floor = sbv::pivot_floor<X>(sigma2);

  for (int k = threadIdx.x; k < d; k += blockDim.x) beta_s[k] = sbv::Coords<X, T>::beta(beta[k]);
  __syncthreads();

  for (int b = blockIdx.x; b < bc; b += gridDim.x) {
    sbv::load_points<T, X>(nn_x + (size_t)b * m * d, nn_m + (size_t)b * m, nn_y + (size_t)b * m,
                           m, blk_x + (size_t)b * bs * d, blk_m + (size_t)b * bs,
                           blk_y + (size_t)b * bs, bs, d, beta_s, work, nrm, msk, ys);
    sbv::assemble<T>(A, N, P, P, d, work, nrm, msk,
                     [=](int, int j) { return ys[j]; }, sigma2, nugget, nu_code);
    sbv::panel_cholesky<T>(A, N, P, work, piv_floor);

    T logdet = T(0), quad = T(0), n_real = T(0);
    for (int t = threadIdx.x; t < bs; t += blockDim.x) {
      const int j = m + t;
      const T mb = msk[j];
      const T v = A[(size_t)j * N + P];
      logdet += log(fmax(A[(size_t)j * N + j], T(1e-30))) * mb;
      quad += v * v;
      n_real += mb;
    }
    logdet = T(2) * sbv::block_sum(logdet, red);
    quad = sbv::block_sum(quad, red);
    n_real = sbv::block_sum(n_real, red);
    if (threadIdx.x == 0) {
      out[b] = T(-0.5) * n_real * T(kLog2Pi) - T(0.5) * logdet - T(0.5) * quad;
    }
    __syncthreads();
  }
}

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads, 2)
sbv_loglik_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
                  const X* __restrict__ blk_x, const T* __restrict__ blk_y,
                  const T* __restrict__ blk_m, const X* __restrict__ nn_x,
                  const T* __restrict__ nn_y, const T* __restrict__ nn_m,
                  T* __restrict__ out, T* __restrict__ scratch,
                  int bc, int bs, int m, int d, int nu_code) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = m + bs;
  const sbv::TiledLayout L(d, P);
  T* beta_s = sm + L.beta();
  T* ys = sm + L.ys();
  T* nrm = sm + L.nrm();
  int* slot = reinterpret_cast<int*>(sm + L.slot());
  T* red = sm + L.red();
  int* counts = reinterpret_cast<int*>(sm + L.counts());
  T* work = sm + L.work();
  T* A = scratch + (size_t)blockIdx.x * (P + 1) * P;
  const T sigma2 = scal[0], nugget = scal[1];
  const T piv_floor = sbv::pivot_floor<X>(sigma2);

  for (int k = threadIdx.x; k < d; k += blockDim.x) beta_s[k] = sbv::Coords<X, T>::beta(beta[k]);
  __syncthreads();

  for (int b = blockIdx.x; b < bc; b += gridDim.x) {
    sbv::load_points_compact<T, X>(nn_x + (size_t)b * m * d, nn_m + (size_t)b * m,
                                   nn_y + (size_t)b * m, m, blk_x + (size_t)b * bs * d,
                                   blk_m + (size_t)b * bs, blk_y + (size_t)b * bs, bs, d,
                                   beta_s, work, P, nrm, ys, slot, counts);
    const int m_real = counts[0], pc = counts[1];
    const int n_blk = pc - m_real;
    // Leading dimension: the real rows and the observation row.
    const int ld = pc + 1;
    if (n_blk > 0) {
      sbv::assemble_compact<T>(A, ld, pc, pc, d, work, P, nrm, ys, sigma2, nugget, nu_code);
      sbv::tiled_cholesky<T>(A, ld, pc + 1, pc, piv_floor, work);
    }
    T logdet = T(0), quad = T(0);
    for (int j = m_real + threadIdx.x; j < pc; j += blockDim.x) {
      const T v = A[(size_t)j * ld + pc];
      logdet += log(fmax(A[(size_t)j * ld + j], T(1e-30)));
      quad += v * v;
    }
    logdet = T(2) * sbv::block_sum(logdet, red);
    quad = sbv::block_sum(quad, red);
    if (threadIdx.x == 0) {
      out[b] = T(-0.5) * T(n_blk) * T(kLog2Pi) - T(0.5) * logdet - T(0.5) * quad;
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int bs, int m, int d) {
  return sizeof(T) * (size_t)sbv::TiledLayout(d, m + bs).total();
}

template <typename T>
size_t panel_smem_bytes(int bs, int m, int d) {
  const int P = m + bs;
  return sizeof(T) * (size_t)sbv::Smem(d, P, P + 1).total();
}

// The tiled kernel (panel = false) or the earlier design (panel = true).
template <typename T, typename X>
struct Route {
  static auto kernel(bool panel) {
    return panel ? sbv_loglik_panel_kernel<T, X> : sbv_loglik_kernel<T, X>;
  }
  static size_t smem(bool panel, int bs, int m, int d) {
    return panel ? panel_smem_bytes<T>(bs, m, d) : smem_bytes<T>(bs, m, d);
  }
};

template <typename T, typename X>
int ctas_per_sm(bool panel, int bs, int m, int d) {
  const size_t smem = Route<T, X>::smem(panel, bs, m, d);
  auto kernel = Route<T, X>::kernel(panel);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, sbv::kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

template <typename T, typename X>
int launch(bool panel, const void* beta, const void* scal, const void* blk_x, const void* blk_y,
           const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m,
           void* out, void* scratch, int bc, int bs, int m, int d, int nu_code, int grid,
           void* stream) {
  const size_t smem = Route<T, X>::smem(panel, bs, m, d);
  auto kernel = Route<T, X>::kernel(panel);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, sbv::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)scal, (const X*)blk_x, (const T*)blk_y, (const T*)blk_m,
      (const X*)nn_x, (const T*)nn_y, (const T*)nn_m, (T*)out, (T*)scratch, bc, bs, m, d,
      nu_code);
  return (int)cudaGetLastError();
}

long long smem_of(bool panel, int bs, int m, int d, int variant) {
  return variant == 1 ? (long long)Route<double, double>::smem(panel, bs, m, d)
                      : (long long)Route<float, float>::smem(panel, bs, m, d);
}

int ctas_of(bool panel, int bs, int m, int d, int variant) {
  return variant == 1   ? ctas_per_sm<double, double>(panel, bs, m, d)
         : variant == 2 ? ctas_per_sm<float, __nv_bfloat16>(panel, bs, m, d)
                        : ctas_per_sm<float, float>(panel, bs, m, d);
}

}  // namespace

extern "C" {

// Scratch elements each CTA needs: N * (m + bs) with N = m + bs + 1 (both
// kernels).
long long sbv_loglik_scratch_per_cta(int bs, int m) {
  return (long long)(m + bs + 1) * (m + bs);
}

// `variant`: 0 f32, 1 f64, 2 bf16 coordinates with f32 working type (its
// scratch and shared memory are f32, as for variant 0).
long long sbv_loglik_smem_bytes(int bs, int m, int d, int variant) {
  return smem_of(false, bs, m, d, variant);
}

// Resident CTAs per SM at this shape; a negative value is minus a CUDA error.
int sbv_loglik_ctas_per_sm(int bs, int m, int d, int variant) {
  return ctas_of(false, bs, m, d, variant);
}

#define SBV_LOGLIK_ENTRY(name, panel, T, X)                                                   \
  int name(const void* beta, const void* scal, const void* blk_x, const void* blk_y,          \
           const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m, void* out, \
           void* scratch, int bc, int bs, int m, int d, int nu_code, int grid, void* stream) { \
    return launch<T, X>(panel, beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out,         \
                        scratch, bc, bs, m, d, nu_code, grid, stream);                         \
  }

// bf16 variants: bf16 coordinates (blk_x, nn_x); beta, scal, observations,
// masks, out and scratch are f32.
SBV_LOGLIK_ENTRY(sbv_loglik_f64, false, double, double)
SBV_LOGLIK_ENTRY(sbv_loglik_f32, false, float, float)
SBV_LOGLIK_ENTRY(sbv_loglik_bf16, false, float, __nv_bfloat16)

// The earlier design (padded blocks, panel_cholesky), for side-by-side
// timings and the card tests only; the same arguments and scratch.
long long sbv_loglik_panel_smem_bytes(int bs, int m, int d, int variant) {
  return smem_of(true, bs, m, d, variant);
}

int sbv_loglik_panel_ctas_per_sm(int bs, int m, int d, int variant) {
  return ctas_of(true, bs, m, d, variant);
}

SBV_LOGLIK_ENTRY(sbv_loglik_panel_f64, true, double, double)
SBV_LOGLIK_ENTRY(sbv_loglik_panel_f32, true, float, float)
SBV_LOGLIK_ENTRY(sbv_loglik_panel_bf16, true, float, __nv_bfloat16)

}  // extern "C"
