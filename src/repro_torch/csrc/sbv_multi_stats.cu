// Fused multi-output SBV block statistics for Hopper (sm_90a): f64, f32, and
// bf16 coordinates with f32 working type (the bf16-assembly tier; pivots
// clamped at 2^-7, eps(bf16) * sigma2 with sigma2 = 1; sbv_common.cuh).
//
// Replaces `sbv_multi_stats_pallas` / `_sbv_multi_kernel` in
// src/repro/kernels/sbv_loglik.py. Per packed block, on the unit-variance
// correlation (sigma2 = 1, nugget = tau2): scaled distances -> Matern(nu) ->
// one blocked Cholesky of the joint (m + bs) covariance with the p masked
// observation columns appended as p extra rows (sbv_common.cuh) -> the row
// [logdet0, q_1 .. q_p]:
//   logdet0 = 2 * sum over real block rows of log max(diag, 1e-30),
//   q_j     = sum of squares of observation row j over the block columns.
// One factorization serves all p outputs; the per-output work is p rows of
// the forward solve, carried by the same elimination.
//
// Bound on an H100: at the multi-output path's shapes (m = 200, bs ~ 260,
// p = 32, f64) a block needs ~4e7 floating-point operations against ~0.16 MB
// of inputs, so the function is bound by operations. The (m + bs + p) x
// (m + bs) panel (~1.8 MB in f64) lives in a per-CTA device-memory scratch
// slice, factored in shared-memory panels of kPanel columns as in the
// likelihood kernel. The p observation rows are written into the panel
// straight from device memory, so shared memory stays at the single-output
// size plus kPanel * p elements: staging Y (P x p values, ~118 KB in f64 at
// p = 32) would cut the resident CTAs per SM. Scalar FMA, like the other
// kernels; the f64 tensor cores (DMMA) are left for later.
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launch (0 on success).
#include "sbv_common.cuh"

namespace {

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads)
sbv_multi_stats_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
                       const X* __restrict__ blk_x, const T* __restrict__ blk_y,
                       const T* __restrict__ blk_m, const X* __restrict__ nn_x,
                       const T* __restrict__ nn_y, const T* __restrict__ nn_m,
                       T* __restrict__ out, T* __restrict__ scratch,
                       int bc, int bs, int m, int d, int p, int nu_code) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = m + bs, N = P + p;
  const sbv::Smem L(d, P, N);
  T* beta_s = sm + L.beta();
  T* msk = sm + L.msk();
  T* nrm = sm + L.nrm();
  T* red = sm + L.red();
  T* work = sm + L.work();
  T* A = scratch + (size_t)blockIdx.x * N * P;
  const T sigma2 = scal[0], nugget = scal[1];
  const T piv_floor = sbv::pivot_floor<X>(sigma2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int k = threadIdx.x; k < d; k += blockDim.x) beta_s[k] = sbv::Coords<X, T>::beta(beta[k]);
  __syncthreads();

  for (int b = blockIdx.x; b < bc; b += gridDim.x) {
    sbv::load_points<T, X>(nn_x + (size_t)b * m * d, nn_m + (size_t)b * m, nullptr, m,
                           blk_x + (size_t)b * bs * d, blk_m + (size_t)b * bs, nullptr, bs, d,
                           beta_s, work, nrm, msk, nullptr);
    const T* ny = nn_y + (size_t)b * m * p;
    const T* by = blk_y + (size_t)b * bs * p;
    // Observation row r at point j: neighbours first, then the block, as the
    // panel's rows; consecutive threads take consecutive r (coalesced).
    sbv::assemble<T>(A, N, P, P, d, work, nrm, msk,
                     [=](int r, int j) {
                       const T y = j < m ? ny[(size_t)j * p + r] : by[(size_t)(j - m) * p + r];
                       return y * msk[j];
                     },
                     sigma2, nugget, nu_code);
    sbv::panel_cholesky<T>(A, N, P, work, piv_floor);

    T logdet = T(0);
    for (int t = threadIdx.x; t < bs; t += blockDim.x) {
      const int j = m + t;
      logdet += log(fmax(A[(size_t)j * N + j], T(1e-30))) * msk[j];
    }
    logdet = T(2) * sbv::block_sum(logdet, red);
    T* o = out + (size_t)b * (1 + p);
    if (threadIdx.x == 0) o[0] = logdet;
    // q_r: one warp per observation row, lanes over the block columns.
    for (int r = warp; r < p; r += n_warps) {
      T s = T(0);
      for (int t = lane; t < bs; t += 32) {
        const T v = A[(size_t)(m + t) * N + P + r];
        s += v * v;
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) o[1 + r] = s;
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int bs, int m, int d, int p) {
  const int P = m + bs;
  return sizeof(T) * (size_t)sbv::Smem(d, P, P + p).total();
}

template <typename T, typename X>
int ctas_per_sm(int bs, int m, int d, int p) {
  const size_t smem = smem_bytes<T>(bs, m, d, p);
  cudaError_t e = cudaFuncSetAttribute(sbv_multi_stats_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sbv_multi_stats_kernel<T, X>,
                                                    sbv::kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

template <typename T, typename X>
int launch(const void* beta, const void* scal, const void* blk_x, const void* blk_y,
           const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m,
           void* out, void* scratch, int bc, int bs, int m, int d, int p, int nu_code, int grid,
           void* stream) {
  const size_t smem = smem_bytes<T>(bs, m, d, p);
  cudaError_t e = cudaFuncSetAttribute(sbv_multi_stats_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sbv_multi_stats_kernel<T, X><<<grid, sbv::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)scal, (const X*)blk_x, (const T*)blk_y, (const T*)blk_m,
      (const X*)nn_x, (const T*)nn_y, (const T*)nn_m, (T*)out, (T*)scratch, bc, bs, m, d, p,
      nu_code);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch elements each CTA needs: N * (m + bs) with N = m + bs + p.
long long sbv_multi_stats_scratch_per_cta(int bs, int m, int p) {
  return (long long)(m + bs + p) * (m + bs);
}

// `variant`: 0 f32, 1 f64, 2 bf16 coordinates with f32 working type.
long long sbv_multi_stats_smem_bytes(int bs, int m, int d, int p, int variant) {
  return variant == 1 ? (long long)smem_bytes<double>(bs, m, d, p)
                      : (long long)smem_bytes<float>(bs, m, d, p);
}

// Resident CTAs per SM at this shape; a negative value is minus a CUDA error.
int sbv_multi_stats_ctas_per_sm(int bs, int m, int d, int p, int variant) {
  return variant == 1   ? ctas_per_sm<double, double>(bs, m, d, p)
         : variant == 2 ? ctas_per_sm<float, __nv_bfloat16>(bs, m, d, p)
                        : ctas_per_sm<float, float>(bs, m, d, p);
}

int sbv_multi_stats_f64(const void* beta, const void* scal, const void* blk_x,
                        const void* blk_y, const void* blk_m, const void* nn_x,
                        const void* nn_y, const void* nn_m, void* out, void* scratch, int bc,
                        int bs, int m, int d, int p, int nu_code, int grid, void* stream) {
  return launch<double, double>(beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out, scratch,
                                bc, bs, m, d, p, nu_code, grid, stream);
}

int sbv_multi_stats_f32(const void* beta, const void* scal, const void* blk_x,
                        const void* blk_y, const void* blk_m, const void* nn_x,
                        const void* nn_y, const void* nn_m, void* out, void* scratch, int bc,
                        int bs, int m, int d, int p, int nu_code, int grid, void* stream) {
  return launch<float, float>(beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out, scratch,
                              bc, bs, m, d, p, nu_code, grid, stream);
}

// bf16 coordinates (blk_x, nn_x); everything else f32.
int sbv_multi_stats_bf16(const void* beta, const void* scal, const void* blk_x,
                         const void* blk_y, const void* blk_m, const void* nn_x,
                         const void* nn_y, const void* nn_m, void* out, void* scratch, int bc,
                         int bs, int m, int d, int p, int nu_code, int grid, void* stream) {
  return launch<float, __nv_bfloat16>(beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out,
                                      scratch, bc, bs, m, d, p, nu_code, grid, stream);
}

}  // extern "C"
