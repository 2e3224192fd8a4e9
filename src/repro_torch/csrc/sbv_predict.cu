// Fused SBV block prediction for Hopper (sm_90a): f64, f32, and bf16
// coordinates with f32 working type (the bf16-assembly tier; pivots clamped
// at eps(bf16) * sigma2; sbv_common.cuh).
//
// Replaces `sbv_predict_pallas` / `_sbv_predict_kernel` and, as a contract,
// `sbv_predict_tiled` in src/repro/kernels/sbv_predict.py: this kernel takes
// any bs and m, so there is no tile padding to do and results cannot depend
// on it. Per prediction block: scaled distances -> Matern(nu) -> Cholesky of
// K(NN, NN) with the query cross-covariances and y_NN carried as extra rows
// -> mu = A^T z (masked) and var = (sigma2 + nugget) - colsum(A * A),
// floored at 1e-12, where A = L^-1 K(NN, Q) and z = L^-1 y_NN.
//
// Bound on an H100: at the main path's shapes (m = 200, bs_pred = 25, f64) a
// block needs ~3.7e6 floating-point operations on its real points against ~18 KB
// of inputs, so it is bound by operations (67 TFLOP/s on the FP64 tensor
// cores).
//
// `sbv_predict_kernel` (the route of all three variants) runs on the
// likelihood kernel's tiled core (sbv_common.cuh):
// * both point sets are compacted (`load_points_compact`: the neighbours
//   with their y as set 0, the queries as set 1), so masked points cost
//   nothing; a masked query's cross-covariance column is zero, so it gets
//   mu = 0 and var = max(prior, 1e-12), as in the padded design;
// * only what the factor reads is assembled: the lower triangle of the
//   first m_real columns (K(NN, NN), K(Q, NN) and the observation row pc);
//   the query-query block is never formed;
// * `tiled_cholesky` factors the m_real columns, the pc - m_real query rows
//   and the observation row riding along as right-hand sides (at m = 200,
//   bs = 25: 226 rows, one pass, 7 panels);
// * one launch serves a whole chunk: the entry point takes a device array
//   of per-bucket descriptors (operand and output pointers, bc, bs, m, and
//   the bucket's first global block index) and the CTAs walk the global
//   block index grid-stride, with shared memory and scratch sized for the
//   largest bucket. A uniform chunk is a one-entry list. A block runs the
//   same instructions whichever list it is in, so the results are bitwise
//   those of one launch per bucket.
// -Xptxas=-v: 128 registers per thread (two CTAs of 256 threads per SM, by
// launch bounds); spills 16 B stored / 24 B loaded in f64, none in f32 or
// in the bf16 variant. Dynamic shared memory, in elements of
// T: d + 3 P + 10 + max(d P, 10816) with P the largest m + bs
// (TiledLayout), 93,984 B in f64 at the path's chunk shape m = 200,
// bs = 104 (bucketed chunks: their largest bucket's P). Scratch per CTA:
// the largest (m + bs + 1) m.
//
// `sbv_predict_panel_kernel` is the earlier design, kept callable through
// the `sbv_predict_panel_*` entry points (one bucket per launch) for a
// side-by-side timing: padded blocks, `panel_cholesky` (right-looking,
// 16-column panels in shared memory, scalar FMA trailing update).
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launch (0 on success).
#include "sbv_common.cuh"

namespace {

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads)
sbv_predict_panel_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
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

// One bucket of a launch: its operands and outputs, bc blocks of bs
// queries and m neighbours, and the global index of its first block. The
// host writes an array of these as int64 words (pointers as addresses).
struct PredictTask {
  const void* q_x;
  const void* q_m;
  const void* nn_x;
  const void* nn_y;
  const void* nn_m;
  void* mu;
  void* var;
  long long bc, bs, m, first;
};
static_assert(sizeof(PredictTask) == 11 * sizeof(long long), "11 int64 words per bucket");

template <typename T, typename X>
__global__ void __launch_bounds__(sbv::kThreads, 2)
sbv_predict_kernel(const T* __restrict__ beta, const T* __restrict__ scal,
                   const PredictTask* __restrict__ tasks, int n_tasks, int total, int d,
                   int p_max, int nu_code, T* __restrict__ scratch, long long scratch_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const sbv::TiledLayout L(d, p_max);
  T* beta_s = sm + L.beta();
  T* ys = sm + L.ys();
  T* nrm = sm + L.nrm();
  int* slot = reinterpret_cast<int*>(sm + L.slot());
  int* counts = reinterpret_cast<int*>(sm + L.counts());
  T* work = sm + L.work();
  T* A = scratch + (size_t)blockIdx.x * scratch_per_cta;
  const T sigma2 = scal[0], nugget = scal[1];
  const T prior = sigma2 + nugget;
  const T piv_floor = sbv::pivot_floor<X>(sigma2);

  for (int k = threadIdx.x; k < d; k += blockDim.x) beta_s[k] = sbv::Coords<X, T>::beta(beta[k]);
  __syncthreads();

  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    int k = 0;
    while (k + 1 < n_tasks && tasks[k + 1].first <= g) ++k;
    const PredictTask& tk = tasks[k];
    const int bs = (int)tk.bs, m = (int)tk.m;
    const size_t b = (size_t)(g - tk.first);
    sbv::load_points_compact<T, X>((const X*)tk.nn_x + b * m * d, (const T*)tk.nn_m + b * m,
                                   (const T*)tk.nn_y + b * m, m, (const X*)tk.q_x + b * bs * d,
                                   (const T*)tk.q_m + b * bs, nullptr, bs, d, beta_s, work,
                                   p_max, nrm, ys, slot, counts);
    const int m_real = counts[0], pc = counts[1];
    // Leading dimension: the real rows and the observation row.
    const int ld = pc + 1;
    if (m_real > 0) {
      sbv::assemble_compact<T>(A, ld, pc, m_real, d, work, p_max, nrm, ys, sigma2, nugget,
                               nu_code);
      sbv::tiled_cholesky<T>(A, ld, pc + 1, m_real, piv_floor, work);
    }
    // Row s of the factored columns is A[:, t]^T for the query t at slot s,
    // row pc is z^T. A masked query (slot -1), or any query of a block
    // with no real neighbour, gets mu = 0 and var = max(prior, 1e-12).
    T* mu_out = (T*)tk.mu + b * bs;
    T* var_out = (T*)tk.var + b * bs;
    for (int t = threadIdx.x; t < bs; t += blockDim.x) {
      const int s = slot[m + t];
      T s2 = T(0), mu = T(0);
      if (s >= 0) {
#pragma unroll 4
        for (int j = 0; j < m_real; ++j) {
          const T a = A[(size_t)j * ld + s];
          s2 += a * a;
          mu += a * A[(size_t)j * ld + pc];
        }
      }
      mu_out[t] = mu;
      var_out[t] = fmax(prior - s2, T(1e-12));
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
  static const void* kernel(bool panel) {
    return panel ? (const void*)sbv_predict_panel_kernel<T, X>
                 : (const void*)sbv_predict_kernel<T, X>;
  }
  static size_t smem(bool panel, int bs, int m, int d) {
    return panel ? panel_smem_bytes<T>(bs, m, d) : smem_bytes<T>(bs, m, d);
  }
};

template <typename T, typename X>
int ctas_per_sm(bool panel, int bs, int m, int d) {
  const size_t smem = Route<T, X>::smem(panel, bs, m, d);
  const void* kernel = Route<T, X>::kernel(panel);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, sbv::kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

// The tiled kernel over a list of buckets; (bs, m) of the bucket with the
// largest m + bs size its shared memory.
template <typename T, typename X>
int launch(const void* beta, const void* scal, const void* tasks, int n_tasks, int total,
           int bs, int m, int d, int nu_code, void* scratch, long long scratch_per_cta, int grid,
           void* stream) {
  const size_t smem = smem_bytes<T>(bs, m, d);
  cudaError_t e = cudaFuncSetAttribute(sbv_predict_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sbv_predict_kernel<T, X><<<grid, sbv::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)scal, (const PredictTask*)tasks, n_tasks, total, d, m + bs,
      nu_code, (T*)scratch, scratch_per_cta);
  return (int)cudaGetLastError();
}

template <typename T, typename X>
int launch_panel(const void* beta, const void* scal, const void* q_x, const void* q_m,
                 const void* nn_x, const void* nn_y, const void* nn_m, void* mu, void* var,
                 void* scratch, int bc, int bs, int m, int d, int nu_code, int grid,
                 void* stream) {
  const size_t smem = panel_smem_bytes<T>(bs, m, d);
  cudaError_t e = cudaFuncSetAttribute(sbv_predict_panel_kernel<T, X>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sbv_predict_panel_kernel<T, X><<<grid, sbv::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)beta, (const T*)scal, (const X*)q_x, (const T*)q_m, (const X*)nn_x,
      (const T*)nn_y, (const T*)nn_m, (T*)mu, (T*)var, (T*)scratch, bc, bs, m, d, nu_code);
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

// Scratch elements each CTA needs for one bucket: N * m with N = m + bs + 1
// (both kernels; a list of buckets takes the largest).
long long sbv_predict_scratch_per_cta(int bs, int m) { return (long long)(m + bs + 1) * m; }

// `variant`: 0 f32, 1 f64, 2 bf16 coordinates with f32 working type.
long long sbv_predict_smem_bytes(int bs, int m, int d, int variant) {
  return smem_of(false, bs, m, d, variant);
}

// Resident CTAs per SM at this shape; a negative value is minus a CUDA error.
int sbv_predict_ctas_per_sm(int bs, int m, int d, int variant) {
  return ctas_of(false, bs, m, d, variant);
}

// One launch over `n_tasks` buckets (`tasks`: a device array of
// PredictTask, in order of `first`; `total` blocks in all). (bs, m) are
// those of the bucket with the largest m + bs; `scratch_per_cta` the
// largest `sbv_predict_scratch_per_cta` of the buckets.
#define SBV_PREDICT_ENTRY(name, T, X)                                                        \
  int name(const void* beta, const void* scal, const void* tasks, int n_tasks, int total,    \
           int bs, int m, int d, int nu_code, void* scratch, long long scratch_per_cta,      \
           int grid, void* stream) {                                                         \
    return launch<T, X>(beta, scal, tasks, n_tasks, total, bs, m, d, nu_code, scratch,       \
                        scratch_per_cta, grid, stream);                                      \
  }

// bf16 variants: bf16 coordinates (q_x, nn_x); everything else f32.
SBV_PREDICT_ENTRY(sbv_predict_f64, double, double)
SBV_PREDICT_ENTRY(sbv_predict_f32, float, float)
SBV_PREDICT_ENTRY(sbv_predict_bf16, float, __nv_bfloat16)

// The earlier design (padded blocks, panel_cholesky, one bucket per
// launch), for side-by-side timings and the card tests only.
long long sbv_predict_panel_smem_bytes(int bs, int m, int d, int variant) {
  return smem_of(true, bs, m, d, variant);
}

int sbv_predict_panel_ctas_per_sm(int bs, int m, int d, int variant) {
  return ctas_of(true, bs, m, d, variant);
}

#define SBV_PREDICT_PANEL_ENTRY(name, T, X)                                                  \
  int name(const void* beta, const void* scal, const void* q_x, const void* q_m,             \
           const void* nn_x, const void* nn_y, const void* nn_m, void* mu, void* var,        \
           void* scratch, int bc, int bs, int m, int d, int nu_code, int grid, void* stream) { \
    return launch_panel<T, X>(beta, scal, q_x, q_m, nn_x, nn_y, nn_m, mu, var, scratch, bc,  \
                              bs, m, d, nu_code, grid, stream);                              \
  }

SBV_PREDICT_PANEL_ENTRY(sbv_predict_panel_f64, double, double)
SBV_PREDICT_PANEL_ENTRY(sbv_predict_panel_f32, float, float)
SBV_PREDICT_PANEL_ENTRY(sbv_predict_panel_bf16, float, __nv_bfloat16)

}  // extern "C"
