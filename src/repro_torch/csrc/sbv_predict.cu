// Fused SBV block prediction for Hopper (sm_90a): f64, f32, and bf16
// coordinates with f32 working type (the bf16-assembly tier; pivots clamped
// at eps(bf16) * sigma2; sbv_common.cuh).
//
// Replaces `sbv_predict_pallas` / `_sbv_predict_kernel` and, as a contract,
// `sbv_predict_tiled` in src/repro/kernels/sbv_predict.py: this kernel takes
// any bs and m, so there is no tile padding to do and results cannot depend
// on it. Per prediction block: scaled distances -> Matern(nu) -> Cholesky of
// K(NN, NN) with the query cross-covariances and y_NN carried as extra rows
// (sbv_common.cuh) -> mu = A^T z (masked) and
// var = (sigma2 + nugget) - colsum(A * A), floored at 1e-12.
//
// Bound on an H100: at the main path's shapes (m = 200, bs = 25, f64) a block
// needs ~4e6 floating-point operations against ~18 KB of inputs, so it is
// bound by operations. The (m + bs + 1) x m panel (~0.7 MB in f64) lives in a
// per-CTA device-memory scratch slice; CTAs walk the blocks grid-stride and
// factor in shared-memory panels of kPanel columns (see sbv_common.cuh).
// Scalar FMA, like the likelihood kernel.
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launch (0 on success).
#include "sbv_common.cuh"

namespace {

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads)
sbv_predict_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
                   const X* __restrict__ q_x, const T* __restrict__ q_m,
                   const X* __restrict__ nn_x, const T* __restrict__ nn_y,
                   const T* __restrict__ nn_m, T* __restrict__ mu_out,
                   T* __restrict__ var_out, T* __restrict__ scratch,
                   int bc, int bs, int m, int d, int nu_code) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = m + bs, N = P + 1;
  const sbv::Smem L(d, P, N);
  T* beta_s = sm + L.beta();
  T* msk = sm + L.msk();
  T* ys = sm + L.ys();
  T* nrm = sm + L.nrm();
  T* work = sm + L.work();
  T* A = scratch + (size_t)blockIdx.x * N * m;
  const T sigma2 = scal[0], nugget = scal[1];
  const T prior = sigma2 + nugget;
  const T piv_floor = sbv::pivot_floor<X>(sigma2);

  for (int k = threadIdx.x; k < d; k += blockDim.x) beta_s[k] = sbv::Coords<X, T>::beta(beta[k]);
  __syncthreads();

  for (int b = blockIdx.x; b < bc; b += gridDim.x) {
    sbv::load_points<T, X>(nn_x + (size_t)b * m * d, nn_m + (size_t)b * m, nn_y + (size_t)b * m,
                           m, q_x + (size_t)b * bs * d, q_m + (size_t)b * bs, nullptr, bs, d,
                           beta_s, work, nrm, msk, ys);
    sbv::assemble<T>(A, N, P, m, d, work, nrm, msk,
                     [=](int, int j) { return ys[j]; }, sigma2, nugget, nu_code);
    sbv::panel_cholesky<T>(A, N, m, work, piv_floor);

    // Row m + t of the factored panel is A[:, t]^T, row P is z^T.
    for (int t = threadIdx.x; t < bs; t += blockDim.x) {
      const int i = m + t;
      T s2 = T(0), mu = T(0);
      for (int j = 0; j < m; ++j) {
        const T a = A[(size_t)j * N + i];
        s2 += a * a;
        mu += a * A[(size_t)j * N + P];
      }
      mu_out[(size_t)b * bs + t] = mu * msk[i];
      var_out[(size_t)b * bs + t] = fmax(prior - s2, T(1e-12));
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int bs, int m, int d) {
  const int P = m + bs;
  return sizeof(T) * (size_t)sbv::Smem(d, P, P + 1).total();
}

template <typename T, typename X>
int ctas_per_sm(int bs, int m, int d) {
  const size_t smem = smem_bytes<T>(bs, m, d);
  cudaError_t e = cudaFuncSetAttribute(sbv_predict_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sbv_predict_kernel<T, X>, sbv::kThreads,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

template <typename T, typename X>
int launch(const void* beta, const void* scal, const void* q_x, const void* q_m,
           const void* nn_x, const void* nn_y, const void* nn_m, void* mu, void* var,
           void* scratch, int bc, int bs, int m, int d, int nu_code, int grid, void* stream) {
  const size_t smem = smem_bytes<T>(bs, m, d);
  cudaError_t e = cudaFuncSetAttribute(sbv_predict_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sbv_predict_kernel<T, X><<<grid, sbv::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)scal, (const X*)q_x, (const T*)q_m, (const X*)nn_x,
      (const T*)nn_y, (const T*)nn_m, (T*)mu, (T*)var, (T*)scratch, bc, bs, m, d, nu_code);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch elements each CTA needs: N * m with N = m + bs + 1.
long long sbv_predict_scratch_per_cta(int bs, int m) { return (long long)(m + bs + 1) * m; }

// `variant`: 0 f32, 1 f64, 2 bf16 coordinates with f32 working type.
long long sbv_predict_smem_bytes(int bs, int m, int d, int variant) {
  return variant == 1 ? (long long)smem_bytes<double>(bs, m, d)
                      : (long long)smem_bytes<float>(bs, m, d);
}

// Resident CTAs per SM at this shape; a negative value is minus a CUDA error.
int sbv_predict_ctas_per_sm(int bs, int m, int d, int variant) {
  return variant == 1   ? ctas_per_sm<double, double>(bs, m, d)
         : variant == 2 ? ctas_per_sm<float, __nv_bfloat16>(bs, m, d)
                        : ctas_per_sm<float, float>(bs, m, d);
}

int sbv_predict_f64(const void* beta, const void* scal, const void* q_x, const void* q_m,
                    const void* nn_x, const void* nn_y, const void* nn_m, void* mu, void* var,
                    void* scratch, int bc, int bs, int m, int d, int nu_code, int grid,
                    void* stream) {
  return launch<double, double>(beta, scal, q_x, q_m, nn_x, nn_y, nn_m, mu, var, scratch, bc, bs,
                                m, d, nu_code, grid, stream);
}

int sbv_predict_f32(const void* beta, const void* scal, const void* q_x, const void* q_m,
                    const void* nn_x, const void* nn_y, const void* nn_m, void* mu, void* var,
                    void* scratch, int bc, int bs, int m, int d, int nu_code, int grid,
                    void* stream) {
  return launch<float, float>(beta, scal, q_x, q_m, nn_x, nn_y, nn_m, mu, var, scratch, bc, bs,
                              m, d, nu_code, grid, stream);
}

// bf16 coordinates (q_x, nn_x); everything else f32.
int sbv_predict_bf16(const void* beta, const void* scal, const void* q_x, const void* q_m,
                     const void* nn_x, const void* nn_y, const void* nn_m, void* mu, void* var,
                     void* scratch, int bc, int bs, int m, int d, int nu_code, int grid,
                     void* stream) {
  return launch<float, __nv_bfloat16>(beta, scal, q_x, q_m, nn_x, nn_y, nn_m, mu, var, scratch,
                                      bc, bs, m, d, nu_code, grid, stream);
}

}  // extern "C"
