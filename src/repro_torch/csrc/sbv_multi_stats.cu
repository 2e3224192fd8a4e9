// Fused multi-output SBV block statistics for Hopper (sm_90a): f64, f32, and
// bf16 coordinates with f32 working type (the bf16-assembly tier; pivots
// clamped at 2^-7, eps(bf16) * sigma2 with sigma2 = 1; sbv_common.cuh).
//
// Replaces `sbv_multi_stats_pallas` / `_sbv_multi_kernel` in
// src/repro/kernels/sbv_loglik.py. Per packed block, on the unit-variance
// correlation (sigma2 = 1, nugget = tau2): scaled distances -> Matern(nu) ->
// one Cholesky of the joint (m + bs) covariance with the p masked
// observation columns appended as p extra rows -> the row
// [logdet0, q_1 .. q_p]:
//   logdet0 = 2 * sum over real block rows of log max(diag, 1e-30),
//   q_j     = sum of squares of observation row j over the block columns.
// One factorization serves all p outputs; the per-output work is p rows of
// the forward solve, carried by the same elimination.
//
// Bound on an H100: at the multi-output path's shapes (m = 200, bs ~ 260,
// p = 32, f64) a block needs ~1.2e7 floating-point operations on its real
// points against ~0.16 MB of inputs, so the function is bound by
// operations (67 TFLOP/s on the FP64 tensor cores).
//
// `sbv_multi_stats_kernel` (the route of all three variants) runs on the
// likelihood kernel's tiled core (sbv_common.cuh):
// * the masked points are left out (`load_points_compact`, the neighbours
//   as set 0 and the block as set 1): a masked point is an identity pivot
//   with y = 0 that touches no other row, so every value of the real rows
//   is unchanged;
// * the p observation rows of compacted column s sit at rows pc .. pc+p-1
//   (leading dimension pc + p), written straight from device memory with
//   the output index fastest, so both the read of y[j, 0..p-1] and the
//   write down the column are coalesced. Staging Y in shared memory (~118
//   KB in f64 at p = 32) would halve the resident CTAs;
// * `tiled_cholesky` factors the pc real columns, the p rows riding along
//   as extra right-hand sides: left-looking 32-column panels, the panel
//   update as FP64 tensor-core tiles (FFMA tiles in f32) fed by `cp.async`,
//   the factor read from the device-memory scratch slice once per panel.
// -Xptxas=-v: 128 registers per thread (two CTAs of 256 threads per SM, by
// launch bounds); spills 12 B stored / 72 B loaded in f64, 8 / 12 B in f32
// and in the bf16 variant. Dynamic shared memory, in elements of
// T: d + 3 P + 10 + max(d P, 10816) (TiledLayout), 97,728 B in f64 at
// m = 200, bs = 260, d = 10. Scratch per CTA: (P + p) x P elements.
//
// `sbv_multi_stats_panel_kernel` is the earlier design, kept callable
// through the `sbv_multi_stats_panel_*` entry points for a side-by-side
// timing: padded blocks, `panel_cholesky` (right-looking, 16-column panels
// in shared memory, scalar FMA trailing update in device memory).
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launch (0 on success).
#include "sbv_common.cuh"

namespace {

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads)
sbv_multi_stats_panel_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
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

// The p observation rows of the compacted block: y[j, r] of point j (the
// neighbours, then the block) at row pc + r of column slot[j]; masked points
// (slot -1) are left out. r is the fastest index, so a warp reads and
// writes contiguous runs.
template <typename T>
__device__ void store_obs_rows(T* __restrict__ A, int ld, int pc, int p, const int* slot,
                               const T* __restrict__ y0, int n0, const T* __restrict__ y1,
                               int n1) {
  for (int e = threadIdx.x; e < (n0 + n1) * p; e += blockDim.x) {
    const int j = e / p, r = e - j * p;
    const int s = slot[j];
    if (s >= 0) A[(size_t)s * ld + pc + r] = j < n0 ? y0[e] : y1[e - n0 * p];
  }
}

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads, 2)
sbv_multi_stats_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
                       const X* __restrict__ blk_x, const T* __restrict__ blk_y,
                       const T* __restrict__ blk_m, const X* __restrict__ nn_x,
                       const T* __restrict__ nn_y, const T* __restrict__ nn_m,
                       T* __restrict__ out, T* __restrict__ scratch,
                       int bc, int bs, int m, int d, int p, int nu_code) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = m + bs;
  const sbv::TiledLayout L(d, P);
  T* beta_s = sm + L.beta();
  T* nrm = sm + L.nrm();
  int* slot = reinterpret_cast<int*>(sm + L.slot());
  T* red = sm + L.red();
  int* counts = reinterpret_cast<int*>(sm + L.counts());
  T* work = sm + L.work();
  T* A = scratch + (size_t)blockIdx.x * (P + p) * P;
  const T sigma2 = scal[0], nugget = scal[1];
  const T piv_floor = sbv::pivot_floor<X>(sigma2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int k = threadIdx.x; k < d; k += blockDim.x) beta_s[k] = sbv::Coords<X, T>::beta(beta[k]);
  __syncthreads();

  for (int b = blockIdx.x; b < bc; b += gridDim.x) {
    sbv::load_points_compact<T, X>(nn_x + (size_t)b * m * d, nn_m + (size_t)b * m, nullptr, m,
                                   blk_x + (size_t)b * bs * d, blk_m + (size_t)b * bs, nullptr,
                                   bs, d, beta_s, work, P, nrm, nullptr, slot, counts);
    const int m_real = counts[0], pc = counts[1];
    // Leading dimension: the real rows and the p observation rows.
    const int ld = pc + p;
    if (pc > m_real) {
      store_obs_rows<T>(A, ld, pc, p, slot, nn_y + (size_t)b * m * p, m,
                        blk_y + (size_t)b * bs * p, bs);
      sbv::assemble_compact<T>(A, ld, pc, pc, d, work, P, nrm, nullptr, sigma2, nugget,
                               nu_code);
      sbv::tiled_cholesky<T>(A, ld, pc + p, pc, piv_floor, work);
    }
    // A block with no real block point writes [0, 0, .., 0]: both loops
    // below are empty.
    T logdet = T(0);
    for (int j = m_real + threadIdx.x; j < pc; j += blockDim.x)
      logdet += log(fmax(A[(size_t)j * ld + j], T(1e-30)));
    logdet = T(2) * sbv::block_sum(logdet, red);
    T* o = out + (size_t)b * (1 + p);
    if (threadIdx.x == 0) o[0] = logdet;
    // q_r: one warp per observation row, lanes over the block columns.
    for (int r = warp; r < p; r += n_warps) {
      T s = T(0);
      for (int j = m_real + lane; j < pc; j += 32) {
        const T v = A[(size_t)j * ld + pc + r];
        s += v * v;
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) o[1 + r] = s;
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int bs, int m, int d) {
  return sizeof(T) * (size_t)sbv::TiledLayout(d, m + bs).total();
}

template <typename T>
size_t panel_smem_bytes(int bs, int m, int d, int p) {
  const int P = m + bs;
  return sizeof(T) * (size_t)sbv::Smem(d, P, P + p).total();
}

// The tiled kernel (panel = false) or the earlier design (panel = true).
template <typename T, typename X>
struct Route {
  static auto kernel(bool panel) {
    return panel ? sbv_multi_stats_panel_kernel<T, X> : sbv_multi_stats_kernel<T, X>;
  }
  static size_t smem(bool panel, int bs, int m, int d, int p) {
    return panel ? panel_smem_bytes<T>(bs, m, d, p) : smem_bytes<T>(bs, m, d);
  }
};

template <typename T, typename X>
int ctas_per_sm(bool panel, int bs, int m, int d, int p) {
  const size_t smem = Route<T, X>::smem(panel, bs, m, d, p);
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
           void* out, void* scratch, int bc, int bs, int m, int d, int p, int nu_code, int grid,
           void* stream) {
  const size_t smem = Route<T, X>::smem(panel, bs, m, d, p);
  auto kernel = Route<T, X>::kernel(panel);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, sbv::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)scal, (const X*)blk_x, (const T*)blk_y, (const T*)blk_m,
      (const X*)nn_x, (const T*)nn_y, (const T*)nn_m, (T*)out, (T*)scratch, bc, bs, m, d, p,
      nu_code);
  return (int)cudaGetLastError();
}

long long smem_of(bool panel, int bs, int m, int d, int p, int variant) {
  return variant == 1 ? (long long)Route<double, double>::smem(panel, bs, m, d, p)
                      : (long long)Route<float, float>::smem(panel, bs, m, d, p);
}

int ctas_of(bool panel, int bs, int m, int d, int p, int variant) {
  return variant == 1   ? ctas_per_sm<double, double>(panel, bs, m, d, p)
         : variant == 2 ? ctas_per_sm<float, __nv_bfloat16>(panel, bs, m, d, p)
                        : ctas_per_sm<float, float>(panel, bs, m, d, p);
}

}  // namespace

extern "C" {

// Scratch elements each CTA needs: N * (m + bs) with N = m + bs + p (both
// kernels).
long long sbv_multi_stats_scratch_per_cta(int bs, int m, int p) {
  return (long long)(m + bs + p) * (m + bs);
}

// `variant`: 0 f32, 1 f64, 2 bf16 coordinates with f32 working type.
long long sbv_multi_stats_smem_bytes(int bs, int m, int d, int p, int variant) {
  return smem_of(false, bs, m, d, p, variant);
}

// Resident CTAs per SM at this shape; a negative value is minus a CUDA error.
int sbv_multi_stats_ctas_per_sm(int bs, int m, int d, int p, int variant) {
  return ctas_of(false, bs, m, d, p, variant);
}

#define SBV_MULTI_ENTRY(name, panel, T, X)                                                     \
  int name(const void* beta, const void* scal, const void* blk_x, const void* blk_y,          \
           const void* blk_m, const void* nn_x, const void* nn_y, const void* nn_m, void* out, \
           void* scratch, int bc, int bs, int m, int d, int p, int nu_code, int grid,          \
           void* stream) {                                                                     \
    return launch<T, X>(panel, beta, scal, blk_x, blk_y, blk_m, nn_x, nn_y, nn_m, out,         \
                        scratch, bc, bs, m, d, p, nu_code, grid, stream);                      \
  }

// bf16 variants: bf16 coordinates (blk_x, nn_x); everything else f32.
SBV_MULTI_ENTRY(sbv_multi_stats_f64, false, double, double)
SBV_MULTI_ENTRY(sbv_multi_stats_f32, false, float, float)
SBV_MULTI_ENTRY(sbv_multi_stats_bf16, false, float, __nv_bfloat16)

// The earlier design (padded blocks, panel_cholesky), for side-by-side
// timings and the card tests only; the same arguments and scratch.
long long sbv_multi_stats_panel_smem_bytes(int bs, int m, int d, int p, int variant) {
  return smem_of(true, bs, m, d, p, variant);
}

int sbv_multi_stats_panel_ctas_per_sm(int bs, int m, int d, int p, int variant) {
  return ctas_of(true, bs, m, d, p, variant);
}

SBV_MULTI_ENTRY(sbv_multi_stats_panel_f64, true, double, double)
SBV_MULTI_ENTRY(sbv_multi_stats_panel_f32, true, float, float)
SBV_MULTI_ENTRY(sbv_multi_stats_panel_bf16, true, float, __nv_bfloat16)

}  // extern "C"
