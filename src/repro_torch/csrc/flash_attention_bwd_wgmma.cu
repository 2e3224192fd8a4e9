// Flash attention (backward) for Hopper (sm_90a), bf16 at head_dim 64, 80,
// 128 and 256: the 'wgmma' route of kernels/flash_attention.py:
// flash_bwd_route.
//
// Replaces no Pallas kernel (the reference differentiates its XLA attention
// route with jax.grad; see csrc/flash_attention_bwd.cu, the 'scalar' route,
// for the function it computes). For q (B, H, S, hd), k and v (B, Hkv, T,
// hd), Hkv | H, the cotangent do (B, H, S, hd), and the row statistics the
// wgmma forward wrote (csrc/flash_attention.cu, `stats`: per query row the
// max m of its masked scores in log2 units, s * log2(e), and 1 / l), it
// returns dq (B, H, S, hd) and dk, dv (B, Hkv, T, hd) in bf16:
//
//   x    = scale * q . k (softcap * tanh(. / softcap) if softcap > 0),
//          in log2 units, -1e30 where the key is not allowed
//   P    = exp2(x - m) * (1 / l)                from the forward's statistics
//   dP   = do . v,   D = sum_j P dP (f32, not do . o: see the scalar route)
//   dS   = allowed ? P (dP - D) (1 - tanh^2 | 1) : 0
//   dq   = scale dS K,  dk = scale dS^T Q,  dv = P^T dO
//
// A row with no allowed key has m = -1e30 exactly (the sentinel, not
// m + log l, which rounds to m), so its P is 1 / l = 1 / T on every key, as
// in the forward; its dS is 0, and its do reaches dv only.
//
// Two kernels, launched one after the other (at hd 256 the dK/dV kernel is
// one of its own), each a CTA of two warpgroups (256 threads). The CTA's
// thread 0 also keeps a ring of TMA loads full: mbarriers, a stage's full
// barrier counting the bytes, its empty barrier the 8 warps that are done
// with it; thread 0 refills the stage of tile i - 1 while tile i's first
// products run. Every product is a `wgmma` with
// bf16 operands and f32 accumulation; tiles are 128-byte swizzled boxes of
// 64 head-dim columns, as in the forward (at hd 80 two boxes, the second
// holding columns 64-79 and TMA's zeros: the products with K = hd take 5
// k-steps, those with N = hd one m64n80k16 a k-step into 40 accumulators a
// thread). The tile shapes depend on hd (`Shape`):
//
// * `flash_bwd_dq_wgmma_kernel`: one CTA per (b * h, 128 query rows), 64
//   per warpgroup, Q and dO resident, K and V streamed in tiles of 64 keys
//   (32 at hd 256) over the causal band and the window, twice. Pass 1:
//   S = Q K^T and dP = dO V^T (m64n64k16, m64n32k16 at hd 256, both
//   operands K-major from shared memory), P from the statistics, and
//   D = sum_j P dP in registers, written to an f32 scratch. Pass 2: S, dP
//   again, dS, and dQ += dS K (m64n{hd}k16, at hd 256 two m64n128k16 on
//   the halves of dQ; A = dS from registers as bf16, B = K MN-major from
//   shared memory). Query tiles run latest first (the longest under a
//   causal mask), so the tail is short.
// * `flash_bwd_dkdv_wgmma_kernel` (hd 64, 80, 128): one CTA per (b * hkv, 128
//   keys), 64 per warpgroup, K and V resident; it walks the 64-row query
//   tiles of the group's n_rep heads (the band, and every tile that holds a
//   row with no allowed key), with Q, dO, and the tile's m, 1 / l and D (1-D
//   bulk copies) streamed. S^T = K Q^T and dP^T = V dO^T (m64n64k16), P^T
//   and dS^T in registers, then dV += P^T dO and dK += dS^T Q (A from
//   registers as bf16, B = dO and Q MN-major). One owner per output
//   element: no atomics, so the same bits on every call. Key tiles run
//   first to last (the longest under a causal mask first).
// * `flash_bwd_dkdv_wgmma256_kernel` (hd 256): one CTA per (b * hkv, 64
//   keys), the same walk. dK and dV of 64 keys at all 256 columns would
//   take 256 registers a thread, so both warpgroups own the CTA's 64 keys
//   and split head_dim: each holds dK and dV for 128 columns. S^T and dP^T
//   are formed once per tile, split by queries: warpgroup w takes the
//   tile's queries [32 w, 32 w + 32) (m64n32k16) and writes its P^T and
//   dS^T as bf16 into two 64 x 64 exchange tiles in shared memory (the
//   128-byte swizzled layout TMA gives a tile; by item parity, 2 x 16 KB);
//   after one barrier both accumulate dV += P^T dO and dK += dS^T Q on
//   their columns (m64n128k16, A and B from shared memory, B MN-major).
//   Forming S^T and dP^T in both warpgroups instead (11 half-products and
//   twice the softcap's tanh, no exchange) ran slower at the gemma2
//   training shape.
//
// Nine half-products in all (S and dP three times, dQ, dK, dV), each a
// (causal half of an) S x T x hd product per head. What bounds it on an
// H100: those products at the bf16 tensor rate (989 TFLOP/s dense); the
// bytes (q, k, v, do read once, dq, dk, dv written once) are far below. At
// hd 256 with gemma2's softcap the accurate tanhf on every score (three
// times: both dQ passes and the dK/dV kernel) costs about as much as the
// products. Gradients are rounded to bf16 once, at the end. ex2 is the
// hardware's ex2.approx and tanh the accurate tanhf, as in the forward.
//
// Registers decide the CTA shape. ptxas gives a thread of a 288- or
// 384-thread CTA (the two warpgroups and a producer warp or warpgroup) the
// 168 registers of a 384-thread one, setmaxnreg or not; the dK/dV
// warpgroup holds dK and dV (2 x 64 f32 at hd 128), S^T and dP^T (2 x 32)
// and the bf16 fragments of P^T and dS^T, so at 168 it spilled ~1 KB and
// ptxas serialised its wgmma. At 256 threads (up to 255 registers)
// -Xptxas=-v (CUDA 12.8, sm_90a) prints, hd 256 / 128 / 80 / 64: dK/dV 195 /
// 227 / 179 / 162 registers, dQ 196 / 162 / 137 / 128, 0 bytes of spills, no
// serialised wgmma. Shared memory at hd 128 and 80: dQ kernel 197,704 B (Q and dO
// 32 KB each, four stages of K and V at 16 KB each, barriers, 1 KB for
// alignment), dK/dV kernel 200,776 B (K and V 32 KB each, four stages of Q
// and dO at 16 KB each and 768 B of statistics); at hd 256: dQ kernel
// 230,456 B (Q and dO 64 KB each, three stages of 32-key K and V at 16 KB
// each: a 64-key stage is 64 KB, and one would not pipeline), dK/dV kernel
// 231,976 B (K and V 32 KB each, two stages of Q and dO at 32 KB each, the
// exchange tiles 32 KB, 768 B of statistics a stage): one CTA per SM.
//
// Plain C interface for ctypes: the entry point returns the CUDA error code
// of the launches (0 on success).
#include <math.h>

#include "flash_hopper.cuh"

namespace {

constexpr int kThreads = 256;    // two warpgroups; thread 0 also issues the copies
constexpr int kQRows = 128;      // query rows a dQ CTA owns: 64 per warpgroup

constexpr int kQStep = 64;       // query rows of a tile the dK/dV kernels stream
constexpr int kXTile = 64 * 128; // a 64 x 64 bf16 tile, one 128-byte swizzled box: 8 KB

// The tile shapes by head_dim (see the header): the dQ kernel's streamed
// key tile and ring depth, the keys a dK/dV CTA owns and its ring depth.
template <int HD>
struct Shape {
  static constexpr bool kWide = HD == 256;
  static constexpr int kKeyStep = kWide ? 32 : 64;   // dQ: keys per streamed tile
  static constexpr int kDqStages = kWide ? 3 : 4;
  static constexpr int kKeyRows = kWide ? 64 : 128;  // dK/dV: keys per CTA
  static constexpr int kKvStages = kWide ? 2 : 4;
};

// Shared memory of the kernels, in bytes from a 1024-byte aligned base: two
// resident tiles of RES rows (Q and dO, or K and V), then STAGES stages of
// two streamed tiles of STEP rows (K and V, or Q and dO), then XBYTES of
// exchange tiles (the hd-256 dK/dV kernel's P^T and dS^T), then, for the
// dK/dV kernels, each stage's statistics (m, 1 / l, D: STEP floats each),
// then the barriers (resident-full, full[STAGES], empty[STAGES]). A tile is
// HD / 64 boxes of ROWS x 128 bytes.
template <int HD, int RES, int STEP, int STAGES, bool STATS, int XBYTES = 0>
struct BwdSmem {
  static constexpr int kResSlab = RES * 128;        // one box of a resident tile
  static constexpr int kStepSlab = STEP * 128;      // one box of a streamed tile
  static constexpr int kBig = n_boxes(HD) * kResSlab;
  static constexpr int kSmall = n_boxes(HD) * kStepSlab;
  static constexpr int kRes = 0;                    // resident tiles: [0], [kBig]
  static constexpr int kRing = 2 * kBig;            // stage st: [kRing + 2 st kSmall], + kSmall
  static constexpr int kX = kRing + STAGES * 2 * kSmall;
  static constexpr int kStat = kX + XBYTES;
  static constexpr int kStatBytes = STATS ? 3 * STEP * 4 : 0;
  static constexpr int kBar = kStat + STAGES * kStatBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * STAGES) + 1024;  // + 1024: base alignment
};

template <int HD>
using DqSmem = BwdSmem<HD, kQRows, Shape<HD>::kKeyStep, Shape<HD>::kDqStages, false>;
// At hd 256 the exchange tiles are P^T and dS^T, twice (by item parity).
template <int HD>
using KvSmem = BwdSmem<HD, Shape<HD>::kKeyRows, kQStep, Shape<HD>::kKvStages, true,
                       Shape<HD>::kWide ? 4 * kXTile : 0>;

__device__ __forceinline__ bool allowed(int i, int j, int causal, int window) {
  const int dist = i - j;
  return (!causal || dist >= 0) && (window <= 0 || dist < window);
}

// The score in log2 units (as the forward forms it) and the softcap's
// derivative 1 - tanh^2.
__device__ __forceinline__ float log2_score(float acc, float scale, float softcap, float& dcap) {
  if (softcap > 0.f) {
    const float t = tanhf(acc * scale / softcap);
    dcap = 1.f - t * t;
    return softcap * t * kLog2e;
  }
  dcap = 1.f;
  return acc * (scale * kLog2e);
}

template <int STAGES>
__device__ __forceinline__ void init_barriers(uint32_t bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar + 8 * (1 + st), 1);
      mbar_init(bar + 8 * (1 + STAGES + st), 8);  // the CTA's 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// D and dQ (see the header).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                          const __grid_constant__ CUtensorMap tmdo,
                          const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv, const float* __restrict__ stats,
                          float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int H,
                          int Hkv, int S, int T_len, Strides dqs, int causal, int window,
                          float softcap, float scale) {
  using L = DqSmem<HD>;
  constexpr int KS = Shape<HD>::kKeyStep;      // keys per streamed tile
  constexpr int STAGES = Shape<HD>::kDqStages;
  constexpr int NSLAB = n_boxes(HD);
  constexpr int OB = HD / 8;  // 8-column blocks of dQ
  constexpr int SA = KS / 2;  // f32 accumulators of a 64 x KS score tile per thread

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kRes, sDO = sQ + L::kBig;
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int st) { return res_full + 8 * (1 + st); };
  auto empty = [&](int st) { return res_full + 8 * (1 + STAGES + st); };
  auto ring = [&](int st) { return base + L::kRing + st * 2 * L::kSmall; };  // K, then V

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;
  // The key tiles of the causal band and the window (rows with no allowed
  // key need none: their dS is 0), each visited twice.
  int kt_begin = 0, kt_end = (T_len + KS - 1) / KS;
  if (window > 0) kt_begin = max(q0 - window + 1, 0) / KS;
  if (causal) kt_end = min(min(q0 + kQRows, S) - 1, T_len - 1) / KS + 1;
  const int n_tiles = max(kt_end - kt_begin, 0);

  init_barriers<STAGES>(res_full);

  // Thread 0 issues the copies: Q and dO, the first STAGES tiles, and each
  // later tile into the stage both warpgroups have released.
  auto issue = [&](int i) {
    const int st = i % STAGES;
    const int k0 = (kt_begin + i % n_tiles) * KS;
    mbar_expect_tx(full(st), 2 * L::kSmall);
    for (int s = 0; s < NSLAB; ++s) {
      tma_load_4d(ring(st) + s * L::kStepSlab, &tmk, full(st), s * kSlab, k0, hk, b);
      tma_load_4d(ring(st) + L::kSmall + s * L::kStepSlab, &tmv, full(st), s * kSlab, k0, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(res_full, 2 * L::kBig);
    for (int s = 0; s < NSLAB; ++s) {
      tma_load_4d(sQ + s * L::kResSlab, &tmq, res_full, s * kSlab, q0, h, b);
      tma_load_4d(sDO + s * L::kResSlab, &tmdo, res_full, s * kSlab, q0, h, b);
    }
    for (int i = 0; i < min(STAGES, 2 * n_tiles); ++i) issue(i);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + 64 * wg;             // the warpgroup's first query row
  const int row0 = wq0 + warp * 16 + g;     // the thread's rows: row0, row0 + 8
  const long long srow = (long long)bh * stats_rows(S);
  const long long plane = (long long)gridDim.x * stats_rows(S);
  float m[2], il[2], dd[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = stats[srow + row0 + 8 * r];
    il[r] = stats[plane + srow + row0 + 8 * r];
  }
  float sacc[SA], pacc[SA], dqacc[OB * 4];
#pragma unroll
  for (int j = 0; j < OB * 4; ++j) dqacc[j] = 0.f;
  uint32_t da[KS / 16][4];

  // S = Q K^T and dP = dO V^T of tile i, as one wgmma group; while they
  // run, thread 0 refills the stage of tile i - 1.
  auto products = [&](int i) {
    const int st = i % STAGES;
    mbar_wait(full(st), (i / STAGES) & 1);
    uint32_t qa = sQ + wg * 64 * 128, doa = sDO + wg * 64 * 128, ka = ring(st);
    asm volatile("" : "+r"(qa), "+r"(doa), "+r"(ka));
    fence_regs<SA>(sacc);
    fence_regs<SA>(pacc);
    wg_fence();
    issue_nt<HD, KS, L::kResSlab, L::kStepSlab>(sacc, qa, ka);
    issue_nt<HD, KS, L::kResSlab, L::kStepSlab>(pacc, doa, ka + L::kSmall);
    wg_commit();
    const int next = i - 1 + STAGES;
    if (threadIdx.x == 0 && i >= 1 && next < 2 * n_tiles) {
      mbar_wait(empty(next % STAGES), ((i - 1) / STAGES) & 1);
      issue(next);
    }
    wg_wait<0>();
    fence_regs<SA>(sacc);
    fence_regs<SA>(pacc);
  };
  // P from the statistics; pass 1 adds P dP into D, pass 2 leaves dS in pacc.
  auto elementwise = [&](int k0, bool pass2) {
    const bool inside = k0 + KS <= T_len && (!causal || k0 + KS - 1 <= wq0) &&
                        (window <= 0 || wq0 + 63 - k0 < window);
#pragma unroll
    for (int j = 0; j < KS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, key = k0 + 8 * j + 2 * t4 + (e % 2);
        float dcap;
        const float x = log2_score(sacc[4 * j + e], scale, softcap, dcap);
        const bool al = inside || (key < T_len && allowed(row0 + 8 * r, key, causal, window));
        const float p = al ? ex2_approx(x - m[r]) * il[r] : 0.f;
        if (pass2) {
          pacc[4 * j + e] = al ? p * (pacc[4 * j + e] - dd[r]) * dcap : 0.f;
        } else {
          dd[r] = fmaf(p, pacc[4 * j + e], dd[r]);
        }
      }
  };

  mbar_wait(res_full, 0);
  int i = 0;
  for (; i < n_tiles; ++i) {
    products(i);
    if (lane == 0) mbar_arrive(empty(i % STAGES));
    elementwise((kt_begin + i) * KS, false);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
    if (t4 == 0) dsum[srow + row0 + 8 * r] = dd[r];
  }
  for (; i < 2 * n_tiles; ++i) {
    products(i);
    elementwise((kt_begin + i - n_tiles) * KS, true);
    pack_frags<KS>(pacc, da);
    uint32_t ka = ring(i % STAGES);
    asm volatile("" : "+r"(ka));
    fence_regs<OB * 4>(dqacc);
    fence_regs<KS / 4>(&da[0][0]);
    wg_fence();
    issue_nn<HD, KS / 16, L::kStepSlab>(dqacc, da, ka);
    wg_commit();
    wg_wait<0>();
    fence_regs<OB * 4>(dqacc);
    if (lane == 0) mbar_arrive(empty(i % STAGES));
  }

  __nv_bfloat16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* out = dqb + (long long)row * dqs.s + t4 * 2;
#pragma unroll
    for (int j = 0; j < OB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(dqacc[4 * j + 2 * r] * scale, dqacc[4 * j + 2 * r + 1] * scale);
  }
}

// dK and dV of 128 keys over the group's query heads at hd 64 and 128 (see
// the header).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                            const __grid_constant__ CUtensorMap tmdo,
                            const __grid_constant__ CUtensorMap tmk,
                            const __grid_constant__ CUtensorMap tmv,
                            const float* __restrict__ stats, const float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                            int Hkv, int S, int T_len, Strides dks, Strides dvs, int causal,
                            int window, float softcap, float scale) {
  using L = KvSmem<HD>;
  using Sh = Shape<HD>;
  constexpr int QS = kQStep;                // query rows per streamed tile
  constexpr int STAGES = Sh::kKvStages;
  constexpr int NSLAB = n_boxes(HD);
  constexpr int OB = HD / 8;                // 8-column blocks of dK and dV
  static_assert(!Sh::kWide, "hd 256 has a dK/dV kernel of its own");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  const uint32_t sK = base + L::kRes, sV = sK + L::kBig;
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int st) { return res_full + 8 * (1 + st); };
  auto empty = [&](int st) { return res_full + 8 * (1 + STAGES + st); };
  auto ring = [&](int st) { return base + L::kRing + st * 2 * L::kSmall; };  // Q, then dO

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int n_rep = H / Hkv;
  const int k0 = blockIdx.y * Sh::kKeyRows;
  // The query tiles some pair of the band or the window reaches, and every
  // tile from the first row with no allowed key on (its P is 1 / T on every
  // key, so it reaches dV).
  const int n_qt = (S + QS - 1) / QS;
  const int qt_begin = causal ? k0 / QS : 0;
  int qt_end = n_qt;
  if (window > 0 && S - 1 < T_len - 1 + window)
    qt_end = min(n_qt, (k0 + Sh::kKeyRows - 1 + window - 1) / QS + 1);
  const int nq = max(qt_end - qt_begin, 0);
  const int n_items = n_rep * nq;
  const long long plane = (long long)gridDim.x * n_rep * stats_rows(S);

  init_barriers<STAGES>(res_full);

  // Thread 0 issues the copies: K and V, the first STAGES items, and
  // each later item into the stage both warpgroups have released.
  auto issue = [&](int i) {
    const int st = i % STAGES;
    const int h = hk * n_rep + i / nq, q0 = (qt_begin + i % nq) * QS;
    mbar_expect_tx(full(st), 2 * L::kSmall + L::kStatBytes);
    for (int s = 0; s < NSLAB; ++s) {
      tma_load_4d(ring(st) + s * L::kStepSlab, &tmq, full(st), s * kSlab, q0, h, b);
      tma_load_4d(ring(st) + L::kSmall + s * L::kStepSlab, &tmdo, full(st), s * kSlab, q0, h, b);
    }
    const long long at = (long long)(b * H + h) * stats_rows(S) + q0;
    const uint32_t sst = base + L::kStat + st * L::kStatBytes;
    bulk_load(sst, stats + at, QS * 4, full(st));
    bulk_load(sst + QS * 4, stats + plane + at, QS * 4, full(st));
    bulk_load(sst + 2 * QS * 4, dsum + at, QS * 4, full(st));
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(res_full, 2 * L::kBig);
    for (int s = 0; s < NSLAB; ++s) {
      tma_load_4d(sK + s * L::kResSlab, &tmk, res_full, s * kSlab, k0, hk, b);
      tma_load_4d(sV + s * L::kResSlab, &tmv, res_full, s * kSlab, k0, hk, b);
    }
    for (int i = 0; i < min(STAGES, n_items); ++i) issue(i);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw0 = k0 + 64 * wg;              // the warpgroup's first key
  const int key0 = kw0 + warp * 16 + g;      // the thread's keys: key0, key0 + 8
  float sacc[32], pacc[32], dkacc[OB * 4], dvacc[OB * 4];
#pragma unroll
  for (int j = 0; j < OB * 4; ++j) dkacc[j] = dvacc[j] = 0.f;
  uint32_t pa[QS / 16][4], da[QS / 16][4];

  mbar_wait(res_full, 0);
  for (int i = 0; i < n_items; ++i) {
    const int st = i % STAGES;
    const int q0 = (qt_begin + i % nq) * QS;
    mbar_wait(full(st), (i / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, as one wgmma group.
    uint32_t ka = sK + wg * 64 * 128, va = sV + wg * 64 * 128, qa = ring(st);
    asm volatile("" : "+r"(ka), "+r"(va), "+r"(qa));
    fence_regs<32>(sacc);
    fence_regs<32>(pacc);
    wg_fence();
    issue_nt<HD, QS, L::kResSlab, L::kStepSlab>(sacc, ka, qa);
    issue_nt<HD, QS, L::kResSlab, L::kStepSlab>(pacc, va, qa + L::kSmall);
    wg_commit();
    // While they run: refill the stage of item i - 1 once both warpgroups
    // have released it (the other one is at most a little behind).
    const int next = i - 1 + STAGES;
    if (threadIdx.x == 0 && i >= 1 && next < n_items) {
      mbar_wait(empty(next % STAGES), ((i - 1) / STAGES) & 1);
      issue(next);
    }
    wg_wait<0>();
    fence_regs<32>(sacc);
    fence_regs<32>(pacc);
    // P^T in sacc, dS^T in pacc: rows are keys, columns queries.
    const float* sm = reinterpret_cast<const float*>(gbase + L::kStat + st * L::kStatBytes);
    const bool inside = q0 + QS <= S && kw0 + 64 <= T_len && (!causal || q0 >= kw0 + 63) &&
                        (window <= 0 || q0 + QS - 1 - kw0 < window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + 2 * t4;
      const float2 mq = *reinterpret_cast<const float2*>(sm + qc);
      const float2 iq = *reinterpret_cast<const float2*>(sm + QS + qc);
      const float2 dq2 = *reinterpret_cast<const float2*>(sm + 2 * QS + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, c = e % 2;
        const int key = key0 + 8 * r, row = q0 + qc + c;
        float dcap;
        const float x = log2_score(sacc[4 * j + e], scale, softcap, dcap);
        const bool in = inside || (key < T_len && row < S);
        const bool al = inside || (in && allowed(row, key, causal, window));
        const float p = in ? ex2_approx((al ? x : kNeg) - (c ? mq.y : mq.x)) * (c ? iq.y : iq.x)
                           : 0.f;
        sacc[4 * j + e] = p;
        pacc[4 * j + e] = al ? p * (pacc[4 * j + e] - (c ? dq2.y : dq2.x)) * dcap : 0.f;
      }
    }
    pack_frags<QS>(sacc, pa);
    pack_frags<QS>(pacc, da);

    // dV += P^T dO and dK += dS^T Q, as one wgmma group.
    uint32_t qb = ring(st);
    asm volatile("" : "+r"(qb));
    fence_regs<OB * 4>(dvacc);
    fence_regs<OB * 4>(dkacc);
    fence_regs<QS / 4>(&pa[0][0]);
    fence_regs<QS / 4>(&da[0][0]);
    wg_fence();
    issue_nn<HD, QS / 16, L::kStepSlab>(dvacc, pa, qb + L::kSmall);
    issue_nn<HD, QS / 16, L::kStepSlab>(dkacc, da, qb);
    wg_commit();
    wg_wait<0>();
    fence_regs<OB * 4>(dvacc);
    fence_regs<OB * 4>(dkacc);
    if (lane == 0) mbar_arrive(empty(st));
  }

  __nv_bfloat16* dkb = dk + b * dks.b + hk * dks.h;
  __nv_bfloat16* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= T_len) continue;
    __nv_bfloat16* ok = dkb + (long long)key * dks.s + t4 * 2;
    __nv_bfloat16* ov = dvb + (long long)key * dvs.s + t4 * 2;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ok + j * 8) =
          __floats2bfloat162_rn(dkacc[4 * j + 2 * r] * scale, dkacc[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(ov + j * 8) =
          __floats2bfloat162_rn(dvacc[4 * j + 2 * r], dvacc[4 * j + 2 * r + 1]);
    }
  }
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// acc (64 x 128, f32) += a (64 x 16 KSTEPS bf16, K-major: one 128-byte
// swizzled box of 64 rows at `a`) . b (16 KSTEPS rows x 128 columns,
// MN-major, boxes BSLAB bytes apart): KSTEPS wgmma m64n128k16, not yet
// committed.
template <int KSTEPS, int BSLAB>
__device__ __forceinline__ void issue_sn(float* acc, uint32_t a, uint32_t b) {
  static_assert(KSTEPS <= 4, "issue_sn: a is one box of 64 columns");
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    wgmma_ss_n128_mn(acc, sw128_desc(a + kk * 32, 16, 1024),
                     sw128_desc(b + kk * 16 * 128, BSLAB, 1024));
}

// dK and dV of 64 keys over the group's query heads at hd 256 (see the
// header). Both warpgroups own the CTA's 64 keys. For each 64-row query
// tile, warpgroup w forms S^T = K Q^T and dP^T = V dO^T for the tile's
// queries [32 w, 32 w + 32) (m64n32k16 over the 256 columns), P^T and
// dS^T on its registers, and writes them as bf16 into the exchange tiles
// (64 keys x 64 queries each, one 128-byte swizzled box, K-major: the
// layout TMA gives a tile); after a barrier, each accumulates dV += P^T dO
// and dK += dS^T Q on its 128 head-dim columns over all 64 queries (A and
// B from shared memory, B MN-major). The exchange tiles alternate by item
// parity, so the one barrier per item suffices: a warpgroup reaches item
// i + 1's barrier only after its products of item i are done, so neither
// overwrites the tiles of item i - 1 while the other reads them.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma256_kernel(const __grid_constant__ CUtensorMap tmq,
                               const __grid_constant__ CUtensorMap tmdo,
                               const __grid_constant__ CUtensorMap tmk,
                               const __grid_constant__ CUtensorMap tmv,
                               const float* __restrict__ stats, const float* __restrict__ dsum,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int H, int Hkv, int S, int T_len, Strides dks, Strides dvs,
                               int causal, int window, float softcap, float scale) {
  constexpr int HD = 256;
  using L = KvSmem<HD>;
  constexpr int QS = kQStep;                 // query rows per streamed tile
  constexpr int KR = Shape<HD>::kKeyRows;    // keys per CTA: 64
  constexpr int STAGES = Shape<HD>::kKvStages;
  constexpr int NSLAB = n_boxes(HD);
  constexpr int OB = HD / 2 / 8;             // 8-column blocks of the warpgroup's dK and dV
  static_assert(KR == 64 && L::kX % 1024 == 0, "the exchange tiles are 64 x 64, 1 KB aligned");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  const uint32_t sK = base + L::kRes, sV = sK + L::kBig;
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int st) { return res_full + 8 * (1 + st); };
  auto empty = [&](int st) { return res_full + 8 * (1 + STAGES + st); };
  auto ring = [&](int st) { return base + L::kRing + st * 2 * L::kSmall; };  // Q, then dO

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int n_rep = H / Hkv;
  const int k0 = blockIdx.y * KR;
  // The query tiles, as in the hd-64/128 kernel.
  const int n_qt = (S + QS - 1) / QS;
  const int qt_begin = causal ? k0 / QS : 0;
  int qt_end = n_qt;
  if (window > 0 && S - 1 < T_len - 1 + window)
    qt_end = min(n_qt, (k0 + KR - 1 + window - 1) / QS + 1);
  const int nq = max(qt_end - qt_begin, 0);
  const int n_items = n_rep * nq;
  const long long plane = (long long)gridDim.x * n_rep * stats_rows(S);

  init_barriers<STAGES>(res_full);

  auto issue = [&](int i) {
    const int st = i % STAGES;
    const int h = hk * n_rep + i / nq, q0 = (qt_begin + i % nq) * QS;
    mbar_expect_tx(full(st), 2 * L::kSmall + L::kStatBytes);
    for (int s = 0; s < NSLAB; ++s) {
      tma_load_4d(ring(st) + s * L::kStepSlab, &tmq, full(st), s * kSlab, q0, h, b);
      tma_load_4d(ring(st) + L::kSmall + s * L::kStepSlab, &tmdo, full(st), s * kSlab, q0, h, b);
    }
    const long long at = (long long)(b * H + h) * stats_rows(S) + q0;
    const uint32_t sst = base + L::kStat + st * L::kStatBytes;
    bulk_load(sst, stats + at, QS * 4, full(st));
    bulk_load(sst + QS * 4, stats + plane + at, QS * 4, full(st));
    bulk_load(sst + 2 * QS * 4, dsum + at, QS * 4, full(st));
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(res_full, 2 * L::kBig);
    for (int s = 0; s < NSLAB; ++s) {
      tma_load_4d(sK + s * L::kResSlab, &tmk, res_full, s * kSlab, k0, hk, b);
      tma_load_4d(sV + s * L::kResSlab, &tmv, res_full, s * kSlab, k0, hk, b);
    }
    for (int i = 0; i < min(STAGES, n_items); ++i) issue(i);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kr0 = warp * 16 + g;             // the thread's keys in the tile: kr0, kr0 + 8
  const int key0 = k0 + kr0;
  const int qh = 32 * wg;                    // the warpgroup's queries in a tile
  float sacc[16], pacc[16], dkacc[OB * 4], dvacc[OB * 4];
#pragma unroll
  for (int j = 0; j < OB * 4; ++j) dkacc[j] = dvacc[j] = 0.f;

  mbar_wait(res_full, 0);
  for (int i = 0; i < n_items; ++i) {
    const int st = i % STAGES;
    const int q0 = (qt_begin + i % nq) * QS;
    mbar_wait(full(st), (i / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T on the warpgroup's 32 queries.
    uint32_t ka = sK, va = sV, qa = ring(st) + qh * 128;
    asm volatile("" : "+r"(ka), "+r"(va), "+r"(qa));
    fence_regs<16>(sacc);
    fence_regs<16>(pacc);
    wg_fence();
    issue_nt<HD, 32, L::kResSlab, L::kStepSlab>(sacc, ka, qa);
    issue_nt<HD, 32, L::kResSlab, L::kStepSlab>(pacc, va, qa + L::kSmall);
    wg_commit();
    const int next = i - 1 + STAGES;
    if (threadIdx.x == 0 && i >= 1 && next < n_items) {
      mbar_wait(empty(next % STAGES), ((i - 1) / STAGES) & 1);
      issue(next);
    }
    wg_wait<0>();
    fence_regs<16>(sacc);
    fence_regs<16>(pacc);

    // P^T and dS^T (rows keys, columns queries) into the exchange tiles.
    const float* sm = reinterpret_cast<const float*>(gbase + L::kStat + st * L::kStatBytes);
    const uint32_t xp = base + L::kX + (i & 1) * 2 * kXTile;  // P^T, then dS^T
    const int qw0 = q0 + qh;
    const bool inside = qw0 + 32 <= S && k0 + KR <= T_len && (!causal || qw0 >= k0 + KR - 1) &&
                        (window <= 0 || qw0 + 31 - k0 < window);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = qh + 8 * j + 2 * t4;    // the pair's first query in the tile
      const float2 mq = *reinterpret_cast<const float2*>(sm + qc);
      const float2 iq = *reinterpret_cast<const float2*>(sm + QS + qc);
      const float2 dq2 = *reinterpret_cast<const float2*>(sm + 2 * QS + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, c = e % 2;
        const int key = key0 + 8 * r, row = q0 + qc + c;
        float dcap;
        const float x = log2_score(sacc[4 * j + e], scale, softcap, dcap);
        const bool in = inside || (key < T_len && row < S);
        const bool al = inside || (in && allowed(row, key, causal, window));
        const float p = in ? ex2_approx((al ? x : kNeg) - (c ? mq.y : mq.x)) * (c ? iq.y : iq.x)
                           : 0.f;
        sacc[4 * j + e] = p;
        pacc[4 * j + e] = al ? p * (pacc[4 * j + e] - (c ? dq2.y : dq2.x)) * dcap : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // Element (kr, qc) of a 128-byte swizzled box: row kr, its 16-byte
        // chunk qc / 8 XOR kr % 8.
        const int kr = kr0 + 8 * r;
        const uint32_t off = kr * 128 + (((qc >> 3) ^ (kr & 7)) << 4) + (qc & 7) * 2;
        st_shared_u32(xp + off, pack_bf16(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));
        st_shared_u32(xp + kXTile + off, pack_bf16(pacc[4 * j + 2 * r], pacc[4 * j + 2 * r + 1]));
      }
    }
    // The stores reach the tensor cores' (async) proxy, and both halves are in place.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1, 256);

    // dV += P^T dO and dK += dS^T Q on the warpgroup's 128 columns, as one wgmma group.
    uint32_t qb = ring(st) + wg * 2 * L::kStepSlab, xa = xp;
    asm volatile("" : "+r"(qb), "+r"(xa));
    fence_regs<OB * 4>(dvacc);
    fence_regs<OB * 4>(dkacc);
    wg_fence();
    issue_sn<QS / 16, L::kStepSlab>(dvacc, xa, qb + L::kSmall);
    issue_sn<QS / 16, L::kStepSlab>(dkacc, xa + kXTile, qb);
    wg_commit();
    wg_wait<0>();
    fence_regs<OB * 4>(dvacc);
    fence_regs<OB * 4>(dkacc);
    if (lane == 0) mbar_arrive(empty(st));
  }

  __nv_bfloat16* dkb = dk + b * dks.b + hk * dks.h + wg * (HD / 2);
  __nv_bfloat16* dvb = dv + b * dvs.b + hk * dvs.h + wg * (HD / 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= T_len) continue;
    __nv_bfloat16* ok = dkb + (long long)key * dks.s + t4 * 2;
    __nv_bfloat16* ov = dvb + (long long)key * dvs.s + t4 * 2;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ok + j * 8) =
          __floats2bfloat162_rn(dkacc[4 * j + 2 * r] * scale, dkacc[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(ov + j * 8) =
          __floats2bfloat162_rn(dvacc[4 * j + 2 * r], dvacc[4 * j + 2 * r + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, const float* stats, float* dsum, int B, int H, int Hkv, int S, int T_len,
           const long long* st, int causal, int window, float softcap, float scale,
           void* stream) {
  using Sh = Shape<HD>;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      dos{st[9], st[10], st[11]}, dqs{st[12], st[13], st[14]}, dks{st[15], st[16], st[17]},
      dvs{st[18], st[19], st[20]};
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // Maps of the resident tiles' boxes (128 query rows for the dQ kernel,
  // kKeyRows keys for the dK/dV kernel) and of the streamed ones (kKeyStep
  // keys, 64 query rows).
  CUtensorMap q_big, do_big, k_small, v_small, q_small, do_small, k_big, v_big;
  if (!make_map(enc, &q_big, q, HD, S, H, B, qs, kQRows) ||
      !make_map(enc, &do_big, dout, HD, S, H, B, dos, kQRows) ||
      !make_map(enc, &k_small, k, HD, T_len, Hkv, B, ks, Sh::kKeyStep) ||
      !make_map(enc, &v_small, v, HD, T_len, Hkv, B, vs, Sh::kKeyStep) ||
      !make_map(enc, &q_small, q, HD, S, H, B, qs, kQStep) ||
      !make_map(enc, &do_small, dout, HD, S, H, B, dos, kQStep) ||
      !make_map(enc, &k_big, k, HD, T_len, Hkv, B, ks, Sh::kKeyRows) ||
      !make_map(enc, &v_big, v, HD, T_len, Hkv, B, vs, Sh::kKeyRows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t cs = (cudaStream_t)stream;
  const int n_q = (S + kQRows - 1) / kQRows, n_k = (T_len + Sh::kKeyRows - 1) / Sh::kKeyRows;
  if (n_q > 65535 || n_k > 65535) return (int)cudaErrorInvalidConfiguration;

  const int smem_q = DqSmem<HD>::kBytes;
  auto kq = flash_bwd_dq_wgmma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  kq<<<dim3(B * H, n_q), kThreads, smem_q, cs>>>(q_big, do_big, k_small, v_small, stats, dsum,
                                                 (__nv_bfloat16*)dq, H, Hkv, S, T_len, dqs,
                                                 causal, window, softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int smem_kv = KvSmem<HD>::kBytes;
  const dim3 grid_kv(B * Hkv, n_k);
  if constexpr (Sh::kWide) {
    auto kkv = flash_bwd_dkdv_wgmma256_kernel;
    e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (e != cudaSuccess) return (int)e;
    kkv<<<grid_kv, kThreads, smem_kv, cs>>>(q_small, do_small, k_big, v_big, stats, dsum,
                                            (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Hkv, S,
                                            T_len, dks, dvs, causal, window, softcap, scale);
  } else {
    auto kkv = flash_bwd_dkdv_wgmma_kernel<HD>;
    e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (e != cudaSuccess) return (int)e;
    kkv<<<grid_kv, kThreads, smem_kv, cs>>>(q_small, do_small, k_big, v_big, stats, dsum,
                                            (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Hkv, S,
                                            T_len, dks, dvs, causal, window, softcap, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, do (inputs, bf16), dq, dk, dv (outputs, bf16); stats: the wgmma
// forward's statistics (2 x B H x stats_rows(S) f32: m in log2 units, then
// 1 / l); dsum: an f32 scratch of B H x stats_rows(S) floats (D); B, H, Hkv,
// S, T, hd (64, 80, 128 or 256); strides: 21 element strides, (b, h, s) of q, k, v,
// do, dq, dk and dv in that order (hd contiguous, the (b, h, s) strides and
// base addresses of q, k, v and do in whole 16-byte vectors: TMA); causal,
// window, softcap; scale: hd^-0.5 rounded to f32 by the caller.
int flash_attention_bwd_wgmma_bf16(const void* q, const void* k, const void* v, const void* dout,
                                   void* dq, void* dk, void* dv, const void* stats, void* dsum,
                                   int B, int H, int Hkv, int S, int T_len, int hd,
                                   const long long* strides, int causal, int window,
                                   float softcap, float scale, void* stream) {
  const float* sp = (const float*)stats;
  float* dp = (float*)dsum;
  switch (hd) {
    case 64: return launch<64>(q, k, v, dout, dq, dk, dv, sp, dp, B, H, Hkv, S, T_len, strides, causal, window, softcap, scale, stream);
    case 80: return launch<80>(q, k, v, dout, dq, dk, dv, sp, dp, B, H, Hkv, S, T_len, strides, causal, window, softcap, scale, stream);
    case 128: return launch<128>(q, k, v, dout, dq, dk, dv, sp, dp, B, H, Hkv, S, T_len, strides, causal, window, softcap, scale, stream);
    case 256: return launch<256>(q, k, v, dout, dq, dk, dv, sp, dp, B, H, Hkv, S, T_len, strides, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
