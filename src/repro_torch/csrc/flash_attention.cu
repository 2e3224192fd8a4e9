// Flash attention (forward) for Hopper (sm_90a), f32 and bf16.
//
// Replaces `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py. For q (B, H, S, hd) and k, v
// (B, Hkv, T, hd), Hkv | H, it returns (B, H, S, hd) in q's dtype:
//
//   s   = (q * hd^-0.5 in f32) . k            per query row and key
//   s   = softcap * tanh(s / softcap)         if softcap > 0, before the mask
//   s   = allowed ? s : -1e30                 dist = q_pos - k_pos, both from 0
//                                             (top-left aligned): causal ->
//                                             dist >= 0; window > 0 -> dist < window
//   out = softmax(s) . v, accumulated in f32, written as acc / max(l, 1e-30)
//
// with the reference's online-softmax recurrence (running max m, normaliser
// l, accumulator acc; m starts at -1e30, so a row with no allowed key at all
// averages V exactly as the reference does). Query head h reads KV head
// h / (H / Hkv): GQA without a repeated copy of K and V. Any S >= 1, T >= 1:
// the ragged last tiles are masked (keys past T get weight exactly 0), not
// padded. Any strides over (B, H, S) with hd contiguous, so the model's
// (B, S, H, hd) projections go in without a transpose.
//
// Four kernels compute it. The route, by dtype and head_dim (chosen in
// kernels/flash_attention.py, `flash_route`):
//
//   dtype  head_dim     kernel                       entry point
//   bf16   64, 80, 128  flash_fwd_wgmma_kernel       flash_attention_wgmma_bf16
//   bf16   256          flash_fwd_wgmma256_kernel    flash_attention_wgmma_bf16
//   bf16   32           flash_fwd_mma_kernel         flash_attention_mma_bf16
//   f32    every        flash_fwd_kernel (scalar)    flash_attention_f32
//
// (`flash_attention_scalar_bf16`, the scalar kernel on bf16, served hd 256
// until the wgmma kernel did; it stays callable at every head_dim for a
// side-by-side timing, and `flash_attention_mma_bf16` likewise at hd 64, 80
// and 128.)
//
// * `flash_fwd_wgmma_kernel` (bf16, hd 64, 80 and 128: internlm2-1.8b,
//   minitron-4b, mistral-large, chameleon-34b at 128, zamba2-2.7b's shared
//   block at 80, musicgen-large at 64):
//   warp-specialised, one producer warpgroup issuing TMA loads of Q and of
//   128-key K/V tiles into a three-stage ring guarded by mbarriers, two
//   consumer warpgroups of 64 query rows each running `wgmma` (see the
//   comment above the kernel). What bounds it on an H100: at the prefill
//   shape its work is 2 B H S^2 hd flop against reading Q, K, V and writing
//   O once, so the bound is the bf16 tensor rate (989 TFLOP/s dense). The
//   design puts every product on `wgmma`, the only route to that rate, keeps
//   the copies off the consumers' instruction stream (TMA, one thread), lets
//   the loads of tiles j + 1 and j + 2 run under the products of tile j, and
//   ping-pongs the two consumer warpgroups so that one's softmax (its
//   scale, mask, exponentials and the rescale of O on the CUDA cores) runs
//   under the other's products.
//   With a non-null `stats` (its `STATS` instantiation; the prefill runs
//   the one without) it also writes each query row's statistics for
//   the backward's wgmma route (csrc/flash_attention_bwd_wgmma.cu): the
//   row max m in log2 units (the unit its scores are kept in) and 1 / l,
//   as two f32 planes of B H x stats_rows(S) floats (csrc/flash_hopper.cuh),
//   one store per row and plane from the first lane of the row's quad,
//   after O. m and 1 / l are kept apart, not as m + log l, so that a row
//   with no allowed key keeps m = -1e30 exactly (m + log l rounds to m).
//   At hd 80 every tile is two 64-column boxes, the second holding columns
//   64-79 and the zeros TMA fills past the tensor's 80 (n_boxes in
//   csrc/flash_hopper.cuh): S = Q K^T takes 5 k-steps, the fifth on the
//   second box, and O += P V one m64n80k16 a k-step, V MN-major across both
//   boxes (its descriptor's leading byte offset is the box stride), into 40
//   accumulators a thread where hd 128 holds 64. -Xptxas=-v (CUDA 12.8,
//   sm_90a): 168 registers per thread (a 384-thread CTA's allotment), 0
//   bytes of spills, no serialised wgmma, at hd 128, 80 and 64 (with and
//   without the statistics); dynamic shared memory 230,480 B at hd 128 and
//   80 (Q 32 KB, three stages of K and V at 32 KB each, the barriers, 1 KB
//   for alignment) and 115,792 B at hd 64: one CTA per SM. Tensor maps are encoded on the host by
//   cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPointByVersion,
//   so the library links no -lcuda. The building blocks it shares with the
//   backward (barriers, TMA, descriptors, wgmma) are in csrc/flash_hopper.cuh.
// * `flash_fwd_wgmma256_kernel` (bf16, hd 256: gemma2-9b): the same
//   function and bound, every product on `wgmma` and every tile on TMA, in
//   a 256-thread CTA of two warpgroups (64 query rows each; thread 0 issues
//   the copies) with 64-key K and V tiles in a two-stage ring, because at
//   hd 256 the output alone takes 128 registers a thread and Q 64 KB of
//   shared memory (see the comment above the kernel). Both instantiations
//   (with and without `stats`) as above. -Xptxas=-v (CUDA 12.8, sm_90a):
//   191 registers (193 with the statistics), 0 bytes of spills, no
//   serialised wgmma; dynamic shared memory 197,704 B (Q 64 KB, two stages
//   of K and V at 32 KB each, the barriers, 1 KB for alignment): one CTA
//   per SM.
// * `flash_fwd_mma_kernel` (bf16, hd 32; also callable at 64, 80 and 128 as
//   the earlier design, for a side-by-side timing): on the tensor cores
//   through `mma.sync` m16n8k16 (bf16 operands, f32 accumulation). One CTA
//   of 4 warps per (b * h, 64 query rows), 16 rows per warp; Q stays in
//   registers as A fragments, each 64-key tile of K and V is copied into
//   shared memory with `cp.async` while the previous one is used (two
//   stages) and read with `ldmatrix` (V transposed), the scores stay in
//   registers, the 4 lanes of a row reduce its max and sum with shuffles,
//   and P goes back into the tensor cores as bf16 A fragments without
//   touching shared memory (the FlashAttention-2 register layout).
// * `flash_fwd_kernel` (f32 at every hd; bf16 only as the baseline): scalar f32
//   FMAs on the CUDA cores (bf16 inputs are widened when staged), so P . V
//   takes P in f32 as the reference does. One CTA of 128 threads per
//   (b * h, BQ query rows); Q (pre-scaled by hd^-0.5, transposed) stays in
//   shared memory, each KV tile of BK keys is staged (K transposed, V as
//   is), each thread keeps an RM x (BK / 8) score micro-tile and an
//   RM x (hd / 8) output micro-tile in registers, the 8 threads of a row
//   reduce with shuffles, and P goes through shared memory; exp is the
//   accurate expf. Bound: the CUDA cores' f32 rate (67 TFLOP/s peak).
//
// Numerics of the bf16 tensor-core kernels: Q K^T is exact products
// summed in f32, then scaled by hd^-0.5 in f32 (the reference scales q
// first; the two differ by f32 rounding); P is rounded to bf16 before
// P . V, where the reference multiplies f32 P by V widened to f32: about
// 4e-3 relative, inside the reference's own bf16 tolerance of 3e-2; exp is
// the hardware's ex2.approx (`__expf` in the mma.sync kernel; the wgmma
// kernel keeps its scores in log2 units, s * log2(e), and calls ex2.approx
// on them directly). Only tiles that cross the causal diagonal, the
// window's edge or the last key are masked.
//
// tanh is the accurate tanhf in all of them. For the causal mask and the
// window, KV tiles that no row of the CTA may see are skipped, unless some
// row of the CTA has no allowed key at all (then every tile counts, as in
// the reference).
//
// Plain C interface for ctypes: every entry point returns the CUDA error code
// of the launch (0 on success).
#include <math.h>

#include "flash_hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTY = 16;  // thread rows of the CTA
constexpr int kTX = 8;   // threads sharing one query row (adjacent lanes of a warp)
constexpr int kPad = 4;  // floats of padding on the transposed tiles' rows

// Query rows (BQ) and keys (BK) per tile, chosen per head_dim so that Q, K,
// V and the P tile fit in shared memory at hd = 256 (111 KB) and so that
// each thread holds at most 64 output accumulators.
template <int HD> struct Tiles;
template <> struct Tiles<32> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<80> { static constexpr int BQ = 64, BK = 32; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 32; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

template <int HD>
constexpr size_t smem_floats() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return (size_t)HD * (BQ + kPad)     // Qt: hd x BQ
         + (size_t)HD * (BK + kPad)   // Kt: hd x BK
         + (size_t)BK * HD            // Vs: BK x hd
         + (size_t)BK * (BQ + kPad);  // Pt: BK x BQ
}

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

// N consecutive floats of shared memory into registers, in the widest
// vectors the (compile-time) alignment allows.
template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "lds: N must be even");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      out[i] = v.x; out[i + 1] = v.y;
    }
  }
}


// The KV tiles [kt_begin, kt_end) a CTA of query rows [q0, q0 + BQ) visits
// (see the header on skipping). Returns whether some row of the CTA has no
// allowed key at all.
__device__ __forceinline__ bool kv_tile_range(int q0, int BQ, int BK, int S, int T_len, int causal,
                                              int window, int& kt_begin, int& kt_end) {
  const int r_last = min(q0 + BQ, S) - 1;
  // Row r has no allowed key when its window starts past the last key
  // (lo = r - window + 1 > T - 1; causal or not, hi >= lo otherwise), and
  // the last row is the first to do so.
  const bool needs_all = window > 0 && r_last - window + 1 > T_len - 1;
  kt_begin = 0;
  kt_end = (T_len + BK - 1) / BK;
  if (!needs_all) {
    if (window > 0) kt_begin = max(q0 - window + 1, 0) / BK;
    if (causal) kt_end = min(r_last, T_len - 1) / BK + 1;
  }
  return needs_all;
}

__device__ __forceinline__ float apply_softcap(float x, float softcap) {
  return softcap > 0.f ? softcap * tanhf(x / softcap) : x;
}

// The score of query row r and key c after the mask: -1e30 where the key is
// not allowed (the reference's sentinel), -inf past the last key (weight
// exactly 0).
__device__ __forceinline__ float mask_score(float x, int r, int c, int T_len, int causal,
                                            int window) {
  const int dist = r - c;
  bool allow = true;
  if (causal) allow = allow && dist >= 0;
  if (window > 0) allow = allow && dist < window;
  x = allow ? x : kNeg;
  return c >= T_len ? -INFINITY : x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int Hkv, int S, int T_len, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, int window, float softcap, float scale) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr int RM = BQ / kTY;   // query rows per thread
  constexpr int SC = BK / kTX;   // score columns per thread
  constexpr int OC = HD / kTX;   // output columns per thread
  constexpr int QLD = BQ + kPad, KLD = BK + kPad;
  constexpr int V4 = HD / 4;     // 4-element vectors per row

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [HD][QLD]
  float* Kt = Qt + HD * QLD;        // [HD][KLD]
  float* Vs = Kt + HD * KLD;        // [BK][HD]
  float* Pt = Vs + BK * HD;         // [BK][QLD]

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // Heavy (late) query tiles of a causal pass first, for the tail.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int kt_begin, kt_end;
  kv_tile_range(q0, BQ, BK, S, T_len, causal, window, kt_begin, kt_end);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // Stage Q, scaled, transposed: Qt[d][r].
  for (int idx = tid; idx < BQ * V4; idx += kThreads) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < S) load4(qb + (long long)(q0 + r) * qs.s + c, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) Qt[(c + j) * QLD + r] = x[j] * scale;
  }

  float m[RM], l[RM], acc[RM][OC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    for (int idx = tid; idx < BK * V4; idx += kThreads) {
      const int r = idx / V4, c = (idx % V4) * 4;
      float xk[4] = {0.f, 0.f, 0.f, 0.f}, xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < T_len) {
        load4(kb + (long long)(k0 + r) * ks.s + c, xk);
        load4(vb + (long long)(k0 + r) * vs.s + c, xv);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Kt[(c + j) * KLD + r] = xk[j];
      *reinterpret_cast<float4*>(Vs + r * HD + c) = make_float4(xv[0], xv[1], xv[2], xv[3]);
    }
    __syncthreads();

    // S = Q K^T on the thread's RM x SC micro-tile.
    float s[RM][SC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RM], kv[SC];
      lds<RM>(Qt + d * QLD + ty * RM, qv);
      lds<SC>(Kt + d * KLD + tx * SC, kv);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Softcap, mask, online softmax.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = q0 + ty * RM + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float x = mask_score(apply_softcap(s[i][j], softcap), r, k0 + tx * SC + j, T_len,
                                   causal, window);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < SC; ++j)
#pragma unroll
      for (int i = 0; i < RM; ++i) Pt[(tx * SC + j) * QLD + ty * RM + i] = s[i][j];
    __syncthreads();

    // acc += P V.
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RM], vv[OC];
      lds<RM>(Pt + kk * QLD + ty * RM, pv);
      lds<OC>(Vs + kk * HD + tx * OC, vv);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = ob + (long long)r * os.s + tx * OC;
#pragma unroll
    for (int c = 0; c < OC; ++c) store1(orow + c, acc[i][c] * inv);
  }
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kMmaRows = 64;  // query rows per CTA: 16 per warp, 4 warps
constexpr int kMmaKeys = 64;  // keys per staged K/V tile

// Q, and two stages of K and V (the next tile lands while this one is used).
template <int HD>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaRows + 4 * kMmaKeys) * (HD + 8) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// Asynchronous copy of rows [0, n_rows) of a (n_rows x HD) bf16 tile at `src`
// (row stride `ld` elements) into shared memory with row stride HD + 8, in
// 16-byte pieces; rows past `valid` are filled with zeros (a source size of
// 0 reads nothing). Completion is awaited with cp.async.wait_group.
template <int HD>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long ld, int n_rows, int valid) {
  constexpr int V8 = HD / 8;
  for (int idx = threadIdx.x; idx < n_rows * V8; idx += kThreads) {
    const int r = idx / V8, c = (idx % V8) * 8;
    const bool in = r < valid;
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + r * (HD + 8) + c);
    const __nv_bfloat16* g = src + (in ? (long long)r * ld : 0) + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(g),
                 "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                     int Hkv, int S, int T_len, Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, int window, float softcap, float scale) {
  constexpr int LD = HD + 8;          // shared-memory row stride (16 B of padding)
  constexpr int KSTEPS = HD / 16;     // k-steps of Q K^T
  constexpr int SB = kMmaKeys / 8;    // 8-key blocks of a score tile
  constexpr int OB = HD / 8;          // 8-column blocks of the output
  static_assert(HD % 16 == 0 && OB % 2 == 0, "head_dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* Ks = Qs + kMmaRows * LD;                           // 2 x [64][LD]
  __nv_bfloat16* Vs = Ks + 2 * kMmaKeys * LD;                       // 2 x [64][LD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;  // row group and column pair of a fragment
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  int kt_begin, kt_end;
  const bool needs_all =
      kv_tile_range(q0, kMmaRows, kMmaKeys, S, T_len, causal, window, kt_begin, kt_end);

  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  auto stage_kv = [&](int kt, int buf) {
    const int k0 = kt * kMmaKeys;
    stage_async<HD>(Ks + buf * kMmaKeys * LD, kb + (long long)k0 * ks.s, ks.s, kMmaKeys,
                    T_len - k0);
    stage_async<HD>(Vs + buf * kMmaKeys * LD, vb + (long long)k0 * vs.s, vs.s, kMmaKeys,
                    T_len - k0);
  };
  stage_async<HD>(Qs, q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, kMmaRows, S - q0);
  stage_kv(kt_begin, 0);
  cp_async_wait<2>();  // Q has landed (the first K/V tile may still be in flight)
  __syncthreads();
  uint32_t qf[KSTEPS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);

  // Rows g and g + 8 of the warp's 16: index 0 and 1 below.
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float oacc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kMmaKeys, buf = (kt - kt_begin) & 1;
    // Start the next tile's copy into the other stage (consumed by the
    // previous iteration, which ended on a barrier), then wait for this one.
    if (kt + 1 < kt_end) {
      stage_kv(kt + 1, buf ^ 1);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kb = Ks + buf * kMmaKeys * LD;
    const __nv_bfloat16* Vb = Vs + buf * kMmaKeys * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, as SB accumulator fragments.
    float sacc[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < SB; j += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, Kb + (j * 8 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(sacc[j], qf[kk], kf[0], kf[1]);
        mma_bf16(sacc[j + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Scale and softcap; the mask only where the tile crosses the causal
    // diagonal, the window's edge or the last key (or where some row has no
    // allowed key); then the online softmax on rows g and g + 8.
    const bool inside = !needs_all && k0 + kMmaKeys <= T_len &&
                        (!causal || k0 + kMmaKeys - 1 <= q0) &&
                        (window <= 0 || q0 + kMmaRows - 1 - k0 < window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = apply_softcap(sacc[j][e] * scale, softcap);
        if (!inside)
          x = mask_score(x, row0 + (e / 2) * 8, k0 + j * 8 + t4 * 2 + (e % 2), T_len, causal,
                         window);
        sacc[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sacc[j][e] - m[e / 2]);
        sacc[j][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      oacc[j][0] *= corr[0]; oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1]; oacc[j][3] *= corr[1];
    }

    // O += P V: P's accumulator fragments are A fragments once packed.
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < OB; j += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vb + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + j * 8 +
                              (lane / 16) * 8);
        mma_bf16(oacc[j], pa, vf[0], vf[1]);
        mma_bf16(oacc[j + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed; the next iteration refills it
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + (long long)r * os.s + t4 * 2;
#pragma unroll
    for (int j = 0; j < OB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(oacc[j][2 * i] * inv, oacc[j][2 * i + 1] * inv);
  }
}

// ------------------------------------------------------- bf16, wgmma ----
//
// `flash_fwd_wgmma_kernel`: one CTA of three warpgroups per (b * h, 128
// query rows). Warpgroups 0 and 1 are consumers, 64 query rows each;
// warpgroup 2 is the producer, of which one thread issues every copy. The
// producer gives up registers (setmaxnreg 40), the consumers take them
// (232). The producer loads Q once and each 128-key tile of K and V into a
// ring of three stages with TMA (4-D tensor maps over (hd, S or T, heads,
// batch), 128-byte swizzle, 64 head-dim columns per box); a stage's full
// barriers (K and V apart) count the bytes, its empty barrier the 8
// consumer warps that are done with it. A consumer computes S = Q K^T with
// `wgmma` m64n128k16 (A = Q and B = K from shared memory, both K-major),
// masks and runs the online softmax on its registers, and accumulates
// O += P V with `wgmma` m64n{hd}k16 (A = P from registers, bf16; B = V from
// shared memory, MN-major). The two consumer warpgroups take turns to issue
// their S products (two named barriers), so that one's softmax overlaps the
// other's products. The products of one warpgroup are not pipelined against
// its own softmax: that needs the S, P and O fragments live at once (~190
// registers), above the 168 that ptxas allots a thread of a 384-thread CTA
// (it serialises the wgmma and spills; setmaxnreg does not lift that limit
// at compile time), and a 288-thread variant (producer warp, 224 registers)
// that held them ran slower than this one. Rows past S and keys past T are
// zero-filled by TMA; keys past T still get the -inf mask.

constexpr int kWgRows = 128;      // query rows per CTA: 64 per consumer warpgroup
constexpr int kWgKeys = 128;      // keys per K/V tile
constexpr int kWgThreads = 384;   // two consumer warpgroups, then the producer warpgroup
constexpr int kSlabBytes = kWgKeys * 128;  // one box of a 128-row tile: 16 KB

constexpr int kWgStages = 3;      // K/V ring depth

// Shared memory, in bytes from a 1024-byte aligned base: Q, K[3], V[3] (one
// 128-row tile each, ceil(hd / 64) boxes of 16 KB), then the barriers
// (q_full, k_full[3], v_full[3], empty[3]). At hd 80 and 128: 224 KB + 1 KB
// of the 227 KB.
template <int HD>
struct WgSmem {
  static constexpr int kTile = n_boxes(HD) * kSlabBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = (1 + kWgStages) * kTile;
  static constexpr int kBar = (1 + 2 * kWgStages) * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kWgStages) + 1024;  // + 1024: base alignment
};

// Whether no score of a warpgroup's tile (its 64 query rows from wq0, KEYS
// keys from k0) needs the mask: the tile lies inside the causal band and
// the window and before the last key, and no row of the CTA lacks an
// allowed key (needs_all; see kv_tile_range).
template <int KEYS>
__device__ __forceinline__ bool tile_inside(bool needs_all, int k0, int wq0, int T_len, int causal,
                                            int window) {
  return !needs_all && k0 + KEYS <= T_len && (!causal || k0 + KEYS - 1 <= wq0) &&
         (window <= 0 || wq0 + 63 - k0 < window);
}

// The online softmax of one wgmma score tile of SB 8-key blocks (the
// accumulator layout of m64n{8 SB}: rows row0 and row0 + 8, keys k0 + 8 j +
// 2 t4 + {0, 1}). Scale and softcap the scores, mask them (only where the
// tile crosses the causal diagonal, the window's edge or the last key, or
// where some row of the CTA has no allowed key: !inside), then update the
// running max m and normaliser l of both rows, with the scores, the running
// max and the masks in log2 units (s * log2(e)), so that each weight is one
// ex2.approx: exp(s - m) stays in sacc; corr gets the factors that rescale
// O. The softcap's tanh applies to the natural-unit score, log2(e) after it.
template <int SB>
__device__ __forceinline__ void online_softmax(float* sacc, float* m, float* l, float* corr,
                                               int row0, int k0, int t4, bool inside, int T_len,
                                               int causal, int window, float softcap,
                                               float scale) {
  if (softcap > 0.f) {
#pragma unroll
    for (int e = 0; e < SB * 4; ++e) sacc[e] = softcap * tanhf(sacc[e] * scale / softcap) * kLog2e;
  } else {
    const float sl2 = scale * kLog2e;
#pragma unroll
    for (int e = 0; e < SB * 4; ++e) sacc[e] *= sl2;
  }
  if (!inside) {
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[4 * j + e] = mask_score(sacc[4 * j + e], row0 + (e / 2) * 8,
                                     k0 + j * 8 + t4 * 2 + (e % 2), T_len, causal, window);
  }
  float mx[2] = {kNeg, kNeg}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < SB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sacc[4 * j + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2_approx(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < SB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2_approx(sacc[4 * j + e] - m[e / 2]);
      sacc[4 * j + e] = p;
      sum[e / 2] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

// O *= corr on an accumulator of OB 8-column blocks (rows row0, row0 + 8).
template <int OB>
__device__ __forceinline__ void rescale(float* oacc, const float* corr) {
#pragma unroll
  for (int j = 0; j < OB; ++j) {
    oacc[4 * j] *= corr[0];
    oacc[4 * j + 1] *= corr[0];
    oacc[4 * j + 2] *= corr[1];
    oacc[4 * j + 3] *= corr[1];
  }
}

// The epilogue of a wgmma forward: O / l as bf16 (rows row0, row0 + 8 of
// OB 8-column blocks), and with STATS each row's m and 1 / l (see the
// header): the 4 lanes of a row hold the same m and l, the first one writes
// them.
template <int OB, bool STATS>
__device__ __forceinline__ void store_rows(const float* oacc, const float* m, const float* l,
                                           __nv_bfloat16* ob, float* stats, long long os_s,
                                           int row0, int t4, int S, int bh, int n_bh) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + (long long)row * os_s + t4 * 2;
#pragma unroll
    for (int j = 0; j < OB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
    if (STATS && t4 == 0) {
      const long long at = (long long)bh * stats_rows(S) + row;
      stats[at] = m[r];
      stats[(long long)n_bh * stats_rows(S) + at] = inv;
    }
  }
}

template <int HD, bool STATS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ stats, int H, int Hkv, int S, int T_len, Strides os,
                       int causal, int window, float softcap, float scale) {
  using L = WgSmem<HD>;
  constexpr int NSLAB = n_boxes(HD);
  constexpr int SB = kWgKeys / 8;  // 8-key blocks of a score tile
  constexpr int OB = HD / 8;       // 8-column blocks of the output
  static_assert(HD == 64 || HD == 80 || HD == 128, "the wgmma route takes head_dim 64, 80 or 128");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kWgStages + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + 2 * kWgStages + st); };

  // The query tiles of one head are neighbours in the grid, so that the CTAs
  // resident at once share a few heads' K and V in L2; heavy (late) query
  // tiles of a causal pass first, for the tail.
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;
  int kt_begin, kt_end;
  const bool needs_all =
      kv_tile_range(q0, kWgRows, kWgKeys, S, T_len, causal, window, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kTile);
      for (int s = 0; s < NSLAB; ++s)
        tma_load_4d(sQ + s * kSlabBytes, &tmq, q_full, s * kSlab, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kWgStages;
        if (i >= kWgStages) mbar_wait(empty(st), (i / kWgStages - 1) & 1);
        const int k0 = (kt_begin + i) * kWgKeys;
        mbar_expect_tx(k_full(st), L::kTile);
        for (int s = 0; s < NSLAB; ++s)
          tma_load_4d(sK + st * L::kTile + s * kSlabBytes, &tmk, k_full(st), s * kSlab, k0, hk, b);
        mbar_expect_tx(v_full(st), L::kTile);
        for (int s = 0; s < NSLAB; ++s)
          tma_load_4d(sV + st * L::kTile + s * kSlabBytes, &tmv, v_full(st), s * kSlab, k0, hk, b);
      }
    }
  } else {
    // Consumers: 64 query rows per warpgroup, 16 per warp.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wq0 = q0 + 64 * wg;  // the warpgroup's first query row
    const int row0 = wq0 + warp * 16 + g;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    float oacc[OB * 4];
#pragma unroll
    for (int j = 0; j < OB * 4; ++j) oacc[j] = 0.f;
    float sacc[SB * 4];
    uint32_t pa[kWgKeys / 16][4];

    // S = Q K^T of the tile in stage st (64 x 128 per warpgroup), issued
    // as one wgmma group.
    auto issue_s = [&](int st) {
      // The bases pass through an empty asm, so the descriptors are rebuilt
      // per tile instead of being held in registers across the loop.
      uint32_t qa = sQ + wg * 64 * 128, ka = sK + st * L::kTile;
      asm volatile("" : "+r"(qa), "+r"(ka));
      fence_regs<SB * 4>(sacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kSlabBytes + (kk % 4) * 32;
        wgmma_ss_n128(sacc, sw128_desc(qa + off, 16, 1024), sw128_desc(ka + off, 16, 1024),
                      kk > 0);
      }
      wg_commit();
    };
    // O += P V of the tile in stage st, issued as one wgmma group.
    auto issue_pv = [&](int st) {
      uint32_t va = sV + st * L::kTile;
      asm volatile("" : "+r"(va));
      fence_regs<OB * 4>(oacc);
      fence_regs<kWgKeys / 4>(&pa[0][0]);
      wg_fence();
      issue_nn<HD, kWgKeys / 16, kSlabBytes>(oacc, pa, va);
      wg_commit();
    };

    // The two consumer warpgroups take turns to issue S = Q K^T (named
    // barriers 1 and 2, 256 threads: one warpgroup waits, the other
    // arrives), so that one's softmax runs while the other's products do;
    // warpgroup 0 goes first.
    float corr[2];
    if (wg == 1) named_arrive(1, 256);
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kWgStages;
      const uint32_t par = (i / kWgStages) & 1;
      mbar_wait(k_full(st), par);
      named_sync(1 + wg, 256);
      issue_s(st);
      if (wg == 0 || i + 1 < n_tiles) named_arrive(2 - wg, 256);
      wg_wait<0>();
      fence_regs<SB * 4>(sacc);
      const int k0 = (kt_begin + i) * kWgKeys;
      online_softmax<SB>(sacc, m, l, corr, row0, k0, t4,
                         tile_inside<kWgKeys>(needs_all, k0, wq0, T_len, causal, window), T_len,
                         causal, window, softcap, scale);
      rescale<OB>(oacc, corr);    // O *= corr
      pack_frags<kWgKeys>(sacc, pa);  // P as bf16 A fragments
      mbar_wait(v_full(st), par);
      issue_pv(st);
      wg_wait<0>();
      fence_regs<OB * 4>(oacc);
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    }

    store_rows<OB, STATS>(oacc, m, l, o + b * os.b + h * os.h, stats, os.s, row0, t4, S, bh,
                          gridDim.y);
  }
}

// ------------------------------------------------ bf16, wgmma, hd 256 ----
//
// `flash_fwd_wgmma256_kernel`: one CTA of two warpgroups (256 threads) per
// (b * h, 128 query rows), 64 rows per warpgroup, as the hd-128 kernel's
// consumers; thread 0 also issues every copy, as in the backward's kernels.
// The hd-128 kernel's shape does not carry over. Registers: O alone is
// 64 x 256 f32 over 128 threads = 128 a thread, a 64-key score tile adds
// 32 and its bf16 P fragments 16, above the 168 that ptxas allots a thread
// of a 288- or 384-thread CTA; at 256 threads a thread may hold 255.
// Shared memory: Q is 64 KB (four 128-byte swizzled boxes of 128 rows x 64
// columns), a 64-key tile of K or V 32 KB, so the ring holds two stages of
// K and V (128 KB). Per tile a warpgroup computes S = Q K^T with 16 `wgmma`
// m64n64k16 (A = Q, B = K, both K-major from shared memory), runs the
// online softmax on its registers, and accumulates O += P V with 4 k-steps
// of two m64n128k16 on the halves of O (A = P from registers as bf16, B =
// V MN-major). K and V have barriers of their own: a stage's K is released
// when both warpgroups' S products are done with it, its V when their P V
// products are, and thread 0 refills the K of tile i + 1 while tile i's S
// products run and its V after its own softmax. The two warpgroups take
// turns to issue their S products (named barriers), as in the hd-128
// kernel. Rows past S and keys past T are zero-filled by TMA; keys past T
// still get the -inf mask.

constexpr int kW2Threads = 256;            // two warpgroups; thread 0 also issues the copies
constexpr int kW2Keys = 64;                // keys per K/V tile
constexpr int kW2Stages = 2;               // K/V ring depth
constexpr int kW2QSlab = kWgRows * 128;    // one box of the 128-row Q tile: 16 KB
constexpr int kW2KSlab = kW2Keys * 128;    // one box of a 64-key tile: 8 KB

// Shared memory, in bytes from a 1024-byte aligned base: Q (64 KB), K[2],
// V[2] (32 KB each), then the barriers (q_full, k_full[2], v_full[2],
// k_empty[2], v_empty[2]): 192 KB + 1 KB of the 227 KB.
struct W2Smem {
  static constexpr int kQ = 0;
  static constexpr int kTile = (256 / kSlab) * kW2KSlab;  // a K or V tile
  static constexpr int kK = (256 / kSlab) * kW2QSlab;
  static constexpr int kV = kK + kW2Stages * kTile;
  static constexpr int kBar = kV + kW2Stages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kW2Stages) + 1024;  // + 1024: base alignment
};

template <bool STATS>
__global__ void __launch_bounds__(kW2Threads, 1)
flash_fwd_wgmma256_kernel(const __grid_constant__ CUtensorMap tmq,
                          const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ stats, int H, int Hkv, int S, int T_len, Strides os,
                          int causal, int window, float softcap, float scale) {
  using L = W2Smem;
  constexpr int HD = 256;
  constexpr int NSLAB = HD / kSlab;
  constexpr int SB = kW2Keys / 8;  // 8-key blocks of a score tile
  constexpr int OB = HD / 8;       // 8-column blocks of the output

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  auto sK = [&](int st) { return base + L::kK + st * L::kTile; };
  auto sV = [&](int st) { return base + L::kV + st * L::kTile; };
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kW2Stages + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * kW2Stages + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * kW2Stages + st); };

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;
  int kt_begin, kt_end;
  const bool needs_all =
      kv_tile_range(q0, kWgRows, kW2Keys, S, T_len, causal, window, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kW2Stages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 8);  // the CTA's 8 warps
      mbar_init(v_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0's copies of K and V of tile i into stage i % kW2Stages.
  auto load_k = [&](int i) {
    const int st = i % kW2Stages, k0 = (kt_begin + i) * kW2Keys;
    mbar_expect_tx(k_full(st), L::kTile);
    for (int s = 0; s < NSLAB; ++s)
      tma_load_4d(sK(st) + s * kW2KSlab, &tmk, k_full(st), s * kSlab, k0, hk, b);
  };
  auto load_v = [&](int i) {
    const int st = i % kW2Stages, k0 = (kt_begin + i) * kW2Keys;
    mbar_expect_tx(v_full(st), L::kTile);
    for (int s = 0; s < NSLAB; ++s)
      tma_load_4d(sV(st) + s * kW2KSlab, &tmv, v_full(st), s * kSlab, k0, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, NSLAB * kW2QSlab);
    for (int s = 0; s < NSLAB; ++s)
      tma_load_4d(sQ + s * kW2QSlab, &tmq, q_full, s * kSlab, q0, h, b);
    for (int i = 0; i < min(kW2Stages, n_tiles); ++i) {
      load_k(i);
      load_v(i);
    }
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + 64 * wg;  // the warpgroup's first query row
  const int row0 = wq0 + warp * 16 + g;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, corr[2];
  float oacc[OB * 4];
#pragma unroll
  for (int j = 0; j < OB * 4; ++j) oacc[j] = 0.f;
  float sacc[SB * 4];
  uint32_t pa[kW2Keys / 16][4];

  // The two warpgroups take turns to issue S = Q K^T (named barriers 1 and
  // 2, as in the hd-128 kernel); warpgroup 0 goes first.
  if (wg == 1) named_arrive(1, 256);
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kW2Stages;
    const uint32_t par = (i / kW2Stages) & 1;
    // Tile i - 1 + kW2Stages goes into the stage of tile i - 1.
    const int next = i - 1 + kW2Stages;
    const bool refill = threadIdx.x == 0 && i >= 1 && next < n_tiles;
    const uint32_t used = ((i - 1) / kW2Stages) & 1;

    mbar_wait(k_full(st), par);
    named_sync(1 + wg, 256);
    {
      uint32_t qa = sQ + wg * 64 * 128, ka = sK(st);
      asm volatile("" : "+r"(qa), "+r"(ka));
      fence_regs<SB * 4>(sacc);
      wg_fence();
      issue_nt<HD, kW2Keys, kW2QSlab, kW2KSlab>(sacc, qa, ka);
      wg_commit();
    }
    if (wg == 0 || i + 1 < n_tiles) named_arrive(2 - wg, 256);
    if (refill) {
      mbar_wait(k_empty(next % kW2Stages), used);
      load_k(next);
    }
    wg_wait<0>();
    fence_regs<SB * 4>(sacc);
    if (lane == 0) mbar_arrive(k_empty(st));  // this warp is done with the stage's K

    const int k0 = (kt_begin + i) * kW2Keys;
    online_softmax<SB>(sacc, m, l, corr, row0, k0, t4,
                       tile_inside<kW2Keys>(needs_all, k0, wq0, T_len, causal, window), T_len,
                       causal, window, softcap, scale);
    rescale<OB>(oacc, corr);
    pack_frags<kW2Keys>(sacc, pa);
    if (refill) {
      mbar_wait(v_empty(next % kW2Stages), used);
      load_v(next);
    }

    mbar_wait(v_full(st), par);
    {
      uint32_t va = sV(st);
      asm volatile("" : "+r"(va));
      fence_regs<OB * 4>(oacc);
      fence_regs<kW2Keys / 4>(&pa[0][0]);
      wg_fence();
      issue_nn<HD, kW2Keys / 16, kW2KSlab>(oacc, pa, va);
      wg_commit();
    }
    wg_wait<0>();
    fence_regs<OB * 4>(oacc);
    if (lane == 0) mbar_arrive(v_empty(st));  // this warp is done with the stage's V
  }

  store_rows<OB, STATS>(oacc, m, l, o + b * os.b + h * os.h, stats, os.s, row0, t4, S, bh,
                        gridDim.y);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* stats, int B, int H,
                 int Hkv, int S, int T_len, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int window, float softcap, float scale, void* stream) {
  constexpr bool kWide = HD == 256;  // the 256-thread kernel and its 64-key tiles
  constexpr int keys = kWide ? kW2Keys : kWgKeys;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tmq, tmk, tmv;
  if (!make_map(enc, &tmq, q, HD, S, H, B, qs, kWgRows) ||
      !make_map(enc, &tmk, k, HD, T_len, Hkv, B, ks, keys) ||
      !make_map(enc, &tmv, v, HD, T_len, Hkv, B, vs, keys))
    return (int)cudaErrorInvalidValue;
  const int n_q = (S + kWgRows - 1) / kWgRows;
  if (B * H > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(n_q, B * H);
  const cudaStream_t cs = (cudaStream_t)stream;
  // The statistics are a template parameter, so that the prefill's kernel
  // (no statistics) is the same code as before they were added.
  cudaError_t e;
  if constexpr (kWide) {
    auto kernel = stats != nullptr ? flash_fwd_wgmma256_kernel<true>
                                   : flash_fwd_wgmma256_kernel<false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W2Smem::kBytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kW2Threads, W2Smem::kBytes, cs>>>(tmq, tmk, tmv, (__nv_bfloat16*)o,
                                                     (float*)stats, H, Hkv, S, T_len, os, causal,
                                                     window, softcap, scale);
  } else {
    auto kernel = stats != nullptr ? flash_fwd_wgmma_kernel<HD, true>
                                   : flash_fwd_wgmma_kernel<HD, false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WgSmem<HD>::kBytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kWgThreads, WgSmem<HD>::kBytes, cs>>>(tmq, tmk, tmv, (__nv_bfloat16*)o,
                                                         (float*)stats, H, Hkv, S, T_len, os,
                                                         causal, window, softcap, scale);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
               int T_len, Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
               float softcap, float scale, void* stream) {
  const size_t smem = mma_smem_bytes<HD>();
  auto kernel = flash_fwd_mma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (S + kMmaRows - 1) / kMmaRows;
  if (n_q > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(B * H, n_q);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           int T_len, Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
           float softcap, float scale, void* stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (S + Tiles<HD>::BQ - 1) / Tiles<HD>::BQ;
  if (n_q > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(B * H, n_q);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, S, T_len, qs, ks, vs, os, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
             int T_len, int hd, const long long* st, int causal, int window, float softcap,
             float scale, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Every entry point takes q, k, v, o; stats (null, or on the wgmma route
// an f32 buffer of 2 x B H x stats_rows(S) floats that receives each row's
// max m and 1 / l, see the header); B, H, Hkv, S, T, hd; strides: 12
// element strides, (b, h, s) of q, k, v and o in that order; causal,
// window, softcap; scale: hd^-0.5 rounded to f32 by the caller, as the
// reference rounds it. Which entry point serves which dtype and head_dim
// is chosen in kernels/flash_attention.py (`flash_route`).

// f32 at every hd: the scalar kernel.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o, void* stats, int B,
                        int H, int Hkv, int S, int T_len, int hd, const long long* strides,
                        int causal, int window, float softcap, float scale, void* stream) {
  if (stats != nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<float>(q, k, v, o, B, H, Hkv, S, T_len, hd, strides, causal, window, softcap,
                         scale, stream);
}

// bf16 at hd in {64, 80, 128}: the warp-specialised wgmma + TMA kernel; at hd
// 256 the 256-thread wgmma + TMA kernel.
int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o, void* stats,
                               int B, int H, int Hkv, int S, int T_len, int hd, const long long* st,
                               int causal, int window, float softcap, float scale,
                               void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, o, stats, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 80: return launch_wgmma<80>(q, k, v, o, stats, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, stats, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 256: return launch_wgmma<256>(q, k, v, o, stats, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 at hd in {32, 64, 80, 128}: the mma.sync kernel (the route at hd 32;
// at 64, 80 and 128 the earlier design, kept callable for a side-by-side
// timing).
int flash_attention_mma_bf16(const void* q, const void* k, const void* v, void* o, void* stats,
                             int B, int H, int Hkv, int S, int T_len, int hd, const long long* st,
                             int causal, int window, float softcap, float scale, void* stream) {
  if (stats != nullptr) return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  switch (hd) {
    case 32: return launch_mma<32>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 64: return launch_mma<64>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 80: return launch_mma<80>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    case 128: return launch_mma<128>(q, k, v, o, B, H, Hkv, S, T_len, qs, ks, vs, os, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 at any hd: the scalar kernel, bf16 widened to f32 when staged (the
// route at hd 256 until the wgmma kernel; kept callable for a side-by-side
// timing).
int flash_attention_scalar_bf16(const void* q, const void* k, const void* v, void* o,
                                void* stats, int B, int H, int Hkv, int S, int T_len, int hd,
                                const long long* st, int causal, int window, float softcap,
                                float scale, void* stream) {
  if (stats != nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, T_len, hd, st, causal, window,
                                 softcap, scale, stream);
}

}  // extern "C"
