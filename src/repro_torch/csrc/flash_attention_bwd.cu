// Flash attention (backward) for Hopper (sm_90a), f32 and bf16: the
// 'scalar' route of kernels/flash_attention.py: flash_bwd_route (f32 at
// every head_dim, bf16 at 32 and 80). bf16 at 64, 128 and 256 takes the
// 'wgmma' route (csrc/flash_attention_bwd_wgmma.cu); these kernels stay
// callable there (`_bwd_launch("scalar", ...)`) as its timed baseline.
//
// Replaces no Pallas kernel: the reference differentiates its XLA attention
// route with jax.grad (src/repro/kernels/flash_attention.py has no
// custom_vjp, and src/repro/models/attention.py keeps training off the
// kernel), so the reference has no backward kernel to port. The port's
// training path runs the forward through csrc/flash_attention.cu, which
// returns a tensor outside autograd; this file is its gradient, written for
// kernels/flash_attention.py: FlashAttention (an autograd.Function).
//
// For q (B, H, S, hd), k and v (B, Hkv, T, hd), Hkv | H, and the cotangent do
// (B, H, S, hd) of the forward's output, it returns dq (B, H, S, hd) and dk,
// dv (B, Hkv, T, hd) in the inputs' dtype, the exact gradient of the
// forward's semantics (csrc/flash_attention.cu, kernels/flash_attention.py:
// flash_attention_plain):
//
//   s    = hd^-0.5 * q . k                      per query row i and key j
//   x    = softcap * tanh(s / softcap)          if softcap > 0, before the mask
//   x    = allowed(i, j) ? x : -1e30            dist = i - j, both from 0
//   P    = softmax_j(x)                         over the T keys
//   dP   = do_i . v_j
//   dS   = allowed(i, j) ? P (dP - D_i) (1 - tanh^2(s / softcap) | 1) : 0,
//          D_i = sum_j P dP
//   dq_i = hd^-0.5 sum_j dS k_j,  dk_j = hd^-0.5 sum_i dS q_i,  dv_j = sum_i P do_i
//
// with KV head h / (H / Hkv) summing the gradients of its H / Hkv query
// heads. A row with no allowed key has P = 1/T on every key (the -1e30
// sentinel, as in the forward) and dS = 0, so its do reaches dv only.
//
// Two kernels, FlashAttention-2's split, launched one after the other:
//
// * `flash_bwd_dq_kernel`: one CTA per (b * h, BQ query rows). It stages Q
//   and dO once, then walks the KV tiles twice: pass 1 recomputes the row
//   max m, the normaliser l and D (online, as the forward accumulates O:
//   sum_j exp(x - m) dP rescaled with m; the scalar and mma.sync forwards
//   write only O), pass 2 forms P = exp(x - m) / l,
//   dP, dS and accumulates dQ. It writes m, 1 / l and D per row into an f32
//   scratch for:
// * `flash_bwd_dkdv_kernel`: one CTA per (b * hkv, BK keys), K and V staged
//   once; it walks the Q tiles of each of the group's n_rep query heads,
//   recomputes P and dS from the scratch, and accumulates dK and dV in
//   registers. No atomics: every output element has one owner, so the
//   gradient is deterministic (the same bits on every run).
//
// D is not taken as do . o: the forward's bf16 routes round P to bf16 before
// P . V, and D from that O would put their ~4e-3 into every dS (a row's dq
// then moved by up to 26 % of its norm on an H100), while sum_j P dP is
// the f32 gradient's own. The kernels need no o. Storing m and 1 / l apart
// (not L = m + log l) keeps a row with no allowed key exact: its m is
// -1e30, where m + log l rounds to m.
//
// Arithmetic: scalar f32 FMAs on the CUDA cores for both dtypes (bf16 inputs
// are widened when staged; outputs are rounded once at the end), with the
// accurate expf and tanhf. What bounds it on an H100: the work is five
// (causal: half-) matrix products of S x T x hd per head (recompute S, dP,
// dV, dK, dQ; this design computes S and dP three times each, nine in
// all), far above the bytes (q, k, v, do read once, dq, dk, dv written
// once), so the bound is the tensor rate of the operands' type. This first
// design runs every product on the CUDA cores (67 TFLOP/s f32 peak): tiles
// live in shared memory as padded rows (hd + 1 floats: the micro-tiles'
// strided rows fall in distinct banks), each thread holds a score micro-tile
// and an accumulator micro-tile in registers. Tiles that no (row, key) pair
// of the CTA may see are skipped (the causal and window bands), except
// where a row has no allowed key at all. The redesign for bf16 at hd 64
// and 128 (wgmma, TMA, the forward emitting m and 1 / l) is
// csrc/flash_attention_bwd_wgmma.cu.
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;          // query rows per tile
constexpr float kNeg = -1e30f;

// Keys per tile: 32, or 16 at hd = 256 so that the dK and dV accumulators
// stay at 64 registers a thread.
template <int HD> struct KeyTile { static constexpr int BK = HD > 128 ? 16 : 32; };

// Score micro-tiles: 8 thread rows (ta) x 16 thread columns (tb); a thread
// owns rows ta + 8 i and columns tb + 16 j. Accumulator micro-tiles: 4 warps
// x 32 lanes; a thread owns rows warp + 4 i and columns lane + 32 c.
constexpr int kSA = 8, kSB = 16;
constexpr int kAW = 4;
static_assert(kSA * kSB == kThreads && kAW * 32 == kThreads, "thread layouts");
static_assert(KeyTile<256>::BK % kSB == 0 && KeyTile<256>::BK % kSA == 0 && kBQ % kSB == 0,
              "tiles divide among the thread layouts");

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + n) of a (rows x HD) global tile (row stride `ld`) into
// shared memory as f32 rows of HD + 1 floats; rows at or past `valid` are
// zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ld, int n, int valid) {
  constexpr int V4 = HD / 4;
  for (int idx = threadIdx.x; idx < n * V4; idx += kThreads) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < valid) load4(src + (long long)r * ld + c, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * (HD + 1) + c + j] = x[j];
  }
}

__device__ __forceinline__ bool allowed(int i, int j, int causal, int window) {
  const int dist = i - j;
  return (!causal || dist >= 0) && (window <= 0 || dist < window);
}

// Whether some (row, key) pair of rows [q0, q1) x keys [k0, k1) is allowed:
// the differences i - j fill [q0 - k1 + 1, q1 - 1 - k0].
__device__ __forceinline__ bool band_meets(int q0, int q1, int k0, int k1, int causal,
                                           int window) {
  const int dmin = q0 - (k1 - 1), dmax = (q1 - 1) - k0;
  if (causal && dmax < 0) return false;
  if (window > 0 && dmin >= window) return false;
  return true;
}

// Whether some row of [q0, q1) has no allowed key among the T keys (its
// window starts past the last key; the last row is the first to do so).
__device__ __forceinline__ bool has_empty_row(int q1, int T_len, int window) {
  return window > 0 && (q1 - 1) - window + 1 > T_len - 1;
}

// The softcapped score and the softcap's derivative at s.
__device__ __forceinline__ float capped(float s, float softcap, float& dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    dcap = 1.f - t * t;
    return softcap * t;
  }
  dcap = 1.f;
  return s;
}

template <int HD>
constexpr size_t dq_smem_floats() {
  constexpr int BK = KeyTile<HD>::BK;
  return (size_t)(2 * kBQ + 2 * BK) * (HD + 1)  // Qs, dOs, Ks, Vs
         + (size_t)kBQ * (BK + 1);              // dSs
}

template <int HD>
constexpr size_t dkdv_smem_floats() {
  constexpr int BK = KeyTile<HD>::BK;
  return (size_t)(2 * kBQ + 2 * BK) * (HD + 1)  // Qs, dOs, Ks, Vs
         + (size_t)2 * kBQ * (BK + 1)           // Ps, dSs
         + 3 * kBQ;                             // Ms, ILs, Ds
}

// dQ and the per-row statistics (see the header).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
                    int H, int Hkv, int S, int T_len, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs, int causal, int window, float softcap,
                    float scale) {
  constexpr int BK = KeyTile<HD>::BK;
  constexpr int LD = HD + 1, PLD = BK + 1;
  constexpr int RA = kBQ / kSA;                 // score rows (queries) per thread
  constexpr int CB = BK / kSB;                   // score columns (keys) per thread
  constexpr int RQ = kBQ / kAW;                 // accumulator rows per thread
  constexpr int DC = (HD + 31) / 32;            // accumulator columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kBQ][LD]
  float* dOs = Qs + kBQ * LD;     // [kBQ][LD]
  float* Ks = dOs + kBQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][LD]
  float* dSs = Vs + BK * LD;      // [kBQ][PLD]

  const int tid = threadIdx.x;
  const int ta = tid / kSB, tb = tid % kSB;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // Heavy (late) query tiles of a causal pass first, for the tail.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q1 = min(q0 + kBQ, S);
  const int n_kt = (T_len + BK - 1) / BK;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  stage<T, HD>(Qs, qb + (long long)q0 * qs.s, qs.s, kBQ, q1 - q0);
  stage<T, HD>(dOs, dob + (long long)q0 * dos.s, dos.s, kBQ, q1 - q0);

  // S = Q K^T and dP = dO V^T of the staged KV tile on the thread's micro-tile.
  float s[RA][CB], dp[RA][CB];
  auto products = [&]() {
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RA], dov[RA], kv[CB], vv[CB];
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        qv[i] = Qs[(ta + kSA * i) * LD + d];
        dov[i] = dOs[(ta + kSA * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        kv[j] = Ks[(tb + kSB * j) * LD + d];
        vv[j] = Vs[(tb + kSB * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
  };

  // Pass 1: the row max m, the normaliser l and sum_j exp(x - m) dP over
  // every visited key.
  const bool all_tiles = has_empty_row(q1, T_len, window);
  float m[RA], l[RA], dl[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    m[i] = kNeg;
    l[i] = dl[i] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, k1 = min(k0 + BK, T_len);
    if (!all_tiles && !band_meets(q0, q1, k0, k1, causal, window)) continue;
    __syncthreads();  // the previous tile's Ks and Vs are consumed
    stage<T, HD>(Ks, kb + (long long)k0 * ks.s, ks.s, BK, k1 - k0);
    stage<T, HD>(Vs, vb + (long long)k0 * vs.s, vs.s, BK, k1 - k0);
    __syncthreads();
    products();
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int r = q0 + ta + kSA * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        const int c = k0 + tb + kSB * j;
        float dcap;
        float x = capped(s[i][j] * scale, softcap, dcap);
        x = allowed(r, c, causal, window) ? x : kNeg;
        x = c < T_len ? x : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kSB; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        dsum = fmaf(e, dp[i][j], dsum);
      }
#pragma unroll
      for (int off = 1; off < kSB; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      dl[i] = dl[i] * corr + dsum;
      m[i] = m_new;
    }
  }
  float il[RA], dr[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    il[i] = 1.f / fmaxf(l[i], 1e-30f);
    dr[i] = dl[i] * il[i];
  }
  const long long srow = (long long)bh * S;
  const long long plane = (long long)gridDim.y * S;  // B * H * S
  if (tb == 0) {
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int r = q0 + ta + kSA * i;
      if (r < S) {
        stats[srow + r] = m[i];
        stats[plane + srow + r] = il[i];
        stats[2 * plane + srow + r] = dr[i];
      }
    }
  }

  // Pass 2: P, dP, dS and dQ += dS K over the keys some row may see.
  float acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, k1 = min(k0 + BK, T_len);
    if (!band_meets(q0, q1, k0, k1, causal, window)) continue;
    __syncthreads();  // the previous tile's Ks, Vs and dSs are consumed
    stage<T, HD>(Ks, kb + (long long)k0 * ks.s, ks.s, BK, k1 - k0);
    stage<T, HD>(Vs, vb + (long long)k0 * vs.s, vs.s, BK, k1 - k0);
    __syncthreads();
    products();
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int rr = ta + kSA * i, r = q0 + rr;
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        const int cc = tb + kSB * j, c = k0 + cc;
        float dcap;
        const float x = capped(s[i][j] * scale, softcap, dcap);
        const bool ok = r < S && c < T_len && allowed(r, c, causal, window);
        const float p = ok ? expf(x - m[i]) * il[i] : 0.f;
        dSs[rr * PLD + cc] = ok ? p * (dp[i][j] - dr[i]) * dcap : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < HD ? Ks[kk * LD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = dSs[(warp + kAW * i) * PLD + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + warp + kAW * i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) store1(dqb + (long long)r * dqs.s + d, acc[i][c] * scale);
    }
  }
}

// dK and dV of one KV tile over the group's query heads (see the header).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ stats,
                      T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int S, int T_len,
                      Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                      int causal, int window, float softcap, float scale) {
  constexpr int BK = KeyTile<HD>::BK;
  constexpr int LD = HD + 1, PLD = BK + 1;
  constexpr int RA = BK / kSA;    // score rows (keys) per thread
  constexpr int CB = kBQ / kSB;   // score columns (queries) per thread
  constexpr int RK = BK / kAW;    // accumulator rows per thread
  constexpr int DC = (HD + 31) / 32;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kBQ][LD]
  float* dOs = Qs + kBQ * LD;     // [kBQ][LD]
  float* Ks = dOs + kBQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][LD]
  float* Ps = Vs + BK * LD;       // [kBQ][PLD]
  float* dSs = Ps + kBQ * PLD;    // [kBQ][PLD]
  float* Ms = dSs + kBQ * PLD;    // [kBQ]
  float* ILs = Ms + kBQ;          // [kBQ]
  float* Ds = ILs + kBQ;          // [kBQ]

  const int tid = threadIdx.x;
  const int ta = tid / kSB, tb = tid % kSB;
  const int warp = tid / 32, lane = tid % 32;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int n_rep = H / Hkv;
  const int k0 = blockIdx.x * BK, k1 = min(k0 + BK, T_len);
  const int n_qt = (S + kBQ - 1) / kBQ;
  const long long plane = (long long)(gridDim.y * n_rep) * S;  // B * H * S

  stage<T, HD>(Ks, k + b * ks.b + hk * ks.h + (long long)k0 * ks.s, ks.s, BK, k1 - k0);
  stage<T, HD>(Vs, v + b * vs.b + hk * vs.h + (long long)k0 * vs.s, vs.s, BK, k1 - k0);

  float adk[RK][DC], adv[RK][DC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int g = 0; g < n_rep; ++g) {
    const int h = hk * n_rep + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long srow = (long long)(b * H + h) * S;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ, q1 = min(q0 + kBQ, S);
      if (!band_meets(q0, q1, k0, k1, causal, window) && !has_empty_row(q1, T_len, window))
        continue;
      __syncthreads();  // the previous tile's Qs, dOs, Ps and dSs are consumed
      stage<T, HD>(Qs, qb + (long long)q0 * qs.s, qs.s, kBQ, q1 - q0);
      stage<T, HD>(dOs, dob + (long long)q0 * dos.s, dos.s, kBQ, q1 - q0);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool in = q0 + r < S;
        Ms[r] = in ? stats[srow + q0 + r] : 0.f;
        ILs[r] = in ? stats[plane + srow + q0 + r] : 0.f;
        Ds[r] = in ? stats[2 * plane + srow + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T on the thread's (keys x queries) micro-tile.
      float s[RA][CB], dp[RA][CB];
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < CB; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[RA], vv[RA], qv[CB], dov[CB];
#pragma unroll
        for (int i = 0; i < RA; ++i) {
          kv[i] = Ks[(ta + kSA * i) * LD + d];
          vv[i] = Vs[(ta + kSA * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          qv[j] = Qs[(tb + kSB * j) * LD + d];
          dov[j] = dOs[(tb + kSB * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RA; ++i)
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int cc = ta + kSA * i, c = k0 + cc;
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          const int rr = tb + kSB * j, r = q0 + rr;
          float dcap;
          float x = capped(s[i][j] * scale, softcap, dcap);
          const bool ok = allowed(r, c, causal, window);
          x = ok ? x : kNeg;
          const bool in = r < S && c < T_len;
          const float p = in ? expf(x - Ms[rr]) * ILs[rr] : 0.f;
          Ps[rr * PLD + cc] = p;
          dSs[rr * PLD + cc] = (in && ok) ? p * (dp[i][j] - Ds[rr]) * dcap : 0.f;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q.
#pragma unroll 2
      for (int rr = 0; rr < kBQ; ++rr) {
        float dov[DC], qv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          dov[c] = d < HD ? dOs[rr * LD + d] : 0.f;
          qv[c] = d < HD ? Qs[rr * LD + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float p = Ps[rr * PLD + warp + kAW * i];
          const float ds = dSs[rr * PLD + warp + kAW * i];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            adv[i][c] = fmaf(p, dov[c], adv[i][c]);
            adk[i][c] = fmaf(ds, qv[c], adk[i][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = k0 + warp + kAW * i;
    if (c >= T_len) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < HD) {
        store1(dkb + (long long)c * dks.s + d, adk[i][cc] * scale);
        store1(dvb + (long long)c * dvs.s + d, adv[i][cc]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, int B, int H, int Hkv, int S, int T_len, const long long* st,
           int causal, int window, float softcap, float scale, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      dos{st[9], st[10], st[11]}, dqs{st[12], st[13], st[14]}, dks{st[15], st[16], st[17]},
      dvs{st[18], st[19], st[20]};
  constexpr int BK = KeyTile<HD>::BK;
  if (B * H > 65535) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t cs = (cudaStream_t)stream;

  const size_t smem_q = dq_smem_floats<HD>() * sizeof(float);
  auto kq = flash_bwd_dq_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((S + kBQ - 1) / kBQ, B * H);
  kq<<<grid_q, kThreads, smem_q, cs>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                       (T*)dq, stats, H, Hkv, S, T_len, qs, ks, vs, dos, dqs,
                                       causal, window, softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = dkdv_smem_floats<HD>() * sizeof(float);
  auto kkv = flash_bwd_dkdv_kernel<T, HD>;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv((T_len + BK - 1) / BK, B * Hkv);
  kkv<<<grid_kv, kThreads, smem_kv, cs>>>((const T*)q, (const T*)k, (const T*)v,
                                          (const T*)dout, stats, (T*)dk, (T*)dv, H, Hkv, S,
                                          T_len, qs, ks, vs, dos, dks, dvs, causal, window,
                                          softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, void* stats, int B, int H, int Hkv, int S, int T_len, int hd,
             const long long* st, int causal, int window, float softcap, float scale,
             void* stream) {
  float* sp = (float*)stats;
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, dout, dq, dk, dv, sp, B, H, Hkv, S, T_len, st, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, dout, dq, dk, dv, sp, B, H, Hkv, S, T_len, st, causal, window, softcap, scale, stream);
    case 80: return launch<T, 80>(q, k, v, dout, dq, dk, dv, sp, B, H, Hkv, S, T_len, st, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, dout, dq, dk, dv, sp, B, H, Hkv, S, T_len, st, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, dout, dq, dk, dv, sp, B, H, Hkv, S, T_len, st, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Both entry points take q, k, v, do (inputs), dq, dk, dv (outputs) and an
// f32 scratch of 3 B H S floats (m, 1 / l, D per query row); B, H, Hkv, S,
// T, hd; strides: 21 element strides, (b, h, s) of q, k, v, do, dq, dk and
// dv in that order; causal, window, softcap; scale: hd^-0.5 rounded
// to f32 by the caller.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                            void* dq, void* dk, void* dv, void* stats, int B, int H, int Hkv,
                            int S, int T_len, int hd, const long long* strides, int causal,
                            int window, float softcap, float scale, void* stream) {
  return dispatch<float>(q, k, v, dout, dq, dk, dv, stats, B, H, Hkv, S, T_len, hd, strides,
                         causal, window, softcap, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, void* stats, int B, int H, int Hkv,
                             int S, int T_len, int hd, const long long* strides, int causal,
                             int window, float softcap, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, B, H, Hkv, S, T_len, hd,
                                 strides, causal, window, softcap, scale, stream);
}

}  // extern "C"
