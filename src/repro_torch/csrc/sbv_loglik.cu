// Fused SBV block log-likelihood for Hopper (sm_90a): f64, f32, and bf16
// coordinates with f32 working type (the precision ladder's bf16-assembly
// tier; see sbv_common.cuh for its rounding and pivot floor).
//
// Replaces `sbv_loglik_pallas` / `_sbv_kernel` in src/repro/kernels/sbv_loglik.py.
// Per packed block: scaled distances -> Matern(nu) -> one blocked Cholesky of
// the joint (m + bs) covariance with y as an extra row (sbv_common.cuh) ->
// log-determinant of the block part + quadratic form -> one scalar.
//
// Bound on an H100: at the main path's shapes (m = 200, bs ~ 290, f64) a block
// needs ~4e7 floating-point operations and reads ~25 KB of inputs, so the
// function is bound by operations (f64 peak), not by bytes. The working set
// (~1.9 MB per block in f64) does not fit in the 227 KB of shared memory a CTA
// can use, so each CTA keeps its panel in a device-memory scratch slice,
// walks the blocks grid-stride, and factors in panels of kPanel columns held
// in shared memory, so the trailing matrix crosses the memory system once per
// panel. The arithmetic is scalar FMA: it cannot reach the f64 tensor-core
// rate (DMMA); that redesign is left for later. The bf16 variant halves the
// coordinate bytes and runs the same chain in f32 (bound by the f32 rate,
// outside the tensor cores), with the f32 panel and scratch of the f32 one.
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launch (0 on success).
#include "sbv_common.cuh"

namespace {

constexpr double kLog2Pi = 1.8378770664093453;

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads)
sbv_loglik_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
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

template <typename T>
size_t smem_bytes(int bs, int m, int d) {
  const int P = m + bs;
  return sizeof(T) * (size_t)sbv::Smem(d, P, P + 1).total();
}

template <typename T, typename X>
int ctas_per_sm(int bs, int m, int d) {
  const size_t smem = smem_bytes<T>(bs, m, d);
  cudaError_t e = cudaFuncSetAttribute(sbv_loglik_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sbv_loglik_kernel<T, X>, sbv::kThreads,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

template <typename T, typename X>
int launch(const void* beta, const void* scal, const void* blk_x, const void* blk_y,
           const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m,
           void* out, void* scratch, int bc, int bs, int m, int d, int nu_code, int grid,
           void* stream) {
  const size_t smem = smem_bytes<T>(bs, m, d);
  cudaError_t e = cudaFuncSetAttribute(sbv_loglik_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sbv_loglik_kernel<T, X><<<grid, sbv::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)scal, (const X*)blk_x, (const T*)blk_y, (const T*)blk_m,
      (const X*)nn_x, (const T*)nn_y, (const T*)nn_m, (T*)out, (T*)scratch, bc, bs, m, d,
      nu_code);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch elements each CTA needs: N * (m + bs) with N = m + bs + 1.
long long sbv_loglik_scratch_per_cta(int bs, int m) {
  return (long long)(m + bs + 1) * (m + bs);
}

// `variant`: 0 f32, 1 f64, 2 bf16 coordinates with f32 working type (its
// scratch and shared memory are f32, as for variant 0).
long long sbv_loglik_smem_bytes(int bs, int m, int d, int variant) {
  return variant == 1 ? (long long)smem_bytes<double>(bs, m, d)
                      : (long long)smem_bytes<float>(bs, m, d);
}

// Resident CTAs per SM at this shape; a negative value is minus a CUDA error.
int sbv_loglik_ctas_per_sm(int bs, int m, int d, int variant) {
  return variant == 1   ? ctas_per_sm<double, double>(bs, m, d)
         : variant == 2 ? ctas_per_sm<float, __nv_bfloat16>(bs, m, d)
                        : ctas_per_sm<float, float>(bs, m, d);
}

int sbv_loglik_f64(const void* beta, const void* scal, const void* blk_x, const void* blk_y,
                   const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m,
                   void* out, void* scratch, int bc, int bs, int m, int d, int nu_code,
                   int grid, void* stream) {
  return launch<double, double>(beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out, scratch,
                                bc, bs, m, d, nu_code, grid, stream);
}

int sbv_loglik_f32(const void* beta, const void* scal, const void* blk_x, const void* blk_y,
                   const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m,
                   void* out, void* scratch, int bc, int bs, int m, int d, int nu_code,
                   int grid, void* stream) {
  return launch<float, float>(beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out, scratch,
                              bc, bs, m, d, nu_code, grid, stream);
}

// bf16 coordinates (blk_x, nn_x); beta, scal, observations, masks, out and
// scratch are f32.
int sbv_loglik_bf16(const void* beta, const void* scal, const void* blk_x, const void* blk_y,
                    const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m,
                    void* out, void* scratch, int bc, int bs, int m, int d, int nu_code,
                    int grid, void* stream) {
  return launch<float, __nv_bfloat16>(beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out,
                                      scratch, bc, bs, m, d, nu_code, grid, stream);
}

}  // extern "C"
