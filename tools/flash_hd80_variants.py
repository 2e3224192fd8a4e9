"""Design variants of the hd-80 flash-attention kernels, timed beside the
library's own on one card, in one process.

Each variant is a source of ``src/repro_torch/csrc`` with one textual edit,
compiled with the library's nvcc flags (``kernels/_build.py``) into a
scratch directory and swapped in for the library's build:

* ``fwd_overlap``: the forward's consumer warpgroup issues S = Q K^T of
  tile i, then O += P V of tile i - 1, and runs tile i's softmax while
  that P V is in flight (its own products pipelined under its softmax);
* ``bwd_overlap``: the dK/dV kernel issues item i + 1's S^T and dP^T
  right after item i's dV and dK products, before waiting on them;
* ``n80_split``: P V and the backward's products with N = 80 as
  m64n64k16 on the first box plus m64n16k16 on the second, into the same
  accumulators, instead of one m64n80k16;
* ``no_hd80``: both wgmma sources without their ``case 80`` (nothing
  instantiated at hd 80), compiled only: the seconds hd 80 adds to the
  build.

For each it prints the nvcc seconds of its sources (in turns with the
library's sources), ``-Xptxas=-v`` of its hd-80 kernels, its holds against
the plain version (the bf16 limits of chip_smoke.py) and its time at
zamba2's path shapes (forward 4 x 4096, backward 4 x 2048, H = Hkv = 32,
causal) beside the library's, in the order A B B A A B, CUDA events,
median of 5. Needs a CUDA device and nvcc:

    python3 tools/flash_hd80_variants.py [variant ...]
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import grad_check, ptxas_summary, row_rel_err  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

FWD, BWD, HOPPER = "flash_attention", "flash_attention_bwd_wgmma", "flash_hopper.cuh"

FWD_LOOP_FROM = """    if (wg == 1) named_arrive(1, 256);
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {"""
FWD_LOOP_TO = """    store_rows<OB, STATS>(oacc, m, l, o + b * os.b + h * os.h, stats, os.s, row0, t4, S, bh,
                          gridDim.y);
  }
}"""
FWD_OVERLAP = """    if (wg == 1) named_arrive(1, 256);
    mbar_wait(q_full, 0);
    auto s_turn = [&](int i) {
      const int st = i % kWgStages;
      mbar_wait(k_full(st), (i / kWgStages) & 1);
      named_sync(1 + wg, 256);
      issue_s(st);
      if (wg == 0 || i + 1 < n_tiles) named_arrive(2 - wg, 256);
    };
    auto softmax_i = [&](int i) {
      const int k0 = (kt_begin + i) * kWgKeys;
      online_softmax<SB>(sacc, m, l, corr, row0, k0, t4,
                         tile_inside<kWgKeys>(needs_all, k0, wq0, T_len, causal, window), T_len,
                         causal, window, softcap, scale);
    };
    if (n_tiles > 0) {
      s_turn(0);
      wg_wait<0>();
      fence_regs<SB * 4>(sacc);
      softmax_i(0);
      rescale<OB>(oacc, corr);
      pack_frags<kWgKeys>(sacc, pa);
      for (int i = 1; i < n_tiles; ++i) {
        s_turn(i);
        const int sp = (i - 1) % kWgStages;
        mbar_wait(v_full(sp), ((i - 1) / kWgStages) & 1);
        issue_pv(sp);
        wg_wait<1>();
        fence_regs<SB * 4>(sacc);
        softmax_i(i);
        wg_wait<0>();
        fence_regs<OB * 4>(oacc);
        if (lane == 0) mbar_arrive(empty(sp));
        rescale<OB>(oacc, corr);
        pack_frags<kWgKeys>(sacc, pa);
      }
      const int sl = (n_tiles - 1) % kWgStages;
      mbar_wait(v_full(sl), ((n_tiles - 1) / kWgStages) & 1);
      issue_pv(sl);
      wg_wait<0>();
      fence_regs<OB * 4>(oacc);
      if (lane == 0) mbar_arrive(empty(sl));
    }

"""

BWD_LOOP_FROM = """  mbar_wait(res_full, 0);
  for (int i = 0; i < n_items; ++i) {
    const int st = i % STAGES;
    const int q0 = (qt_begin + i % nq) * QS;
    mbar_wait(full(st), (i / STAGES) & 1);
"""
BWD_LOOP_TO = """  __nv_bfloat16* dkb = dk + b * dks.b + hk * dks.h;
"""
BWD_OVERLAP = """  auto issue_st = [&](int i) {
    const int st = i % STAGES;
    mbar_wait(full(st), (i / STAGES) & 1);
    uint32_t ka = sK + wg * 64 * 128, va = sV + wg * 64 * 128, qa = ring(st);
    asm volatile("" : "+r"(ka), "+r"(va), "+r"(qa));
    fence_regs<32>(sacc);
    fence_regs<32>(pacc);
    wg_fence();
    issue_nt<HD, QS, L::kResSlab, L::kStepSlab>(sacc, ka, qa);
    issue_nt<HD, QS, L::kResSlab, L::kStepSlab>(pacc, va, qa + L::kSmall);
    wg_commit();
  };
  mbar_wait(res_full, 0);
  if (n_items > 0) issue_st(0);
  for (int i = 0; i < n_items; ++i) {
    const int st = i % STAGES;
    const int q0 = (qt_begin + i % nq) * QS;
    wg_wait<0>();
    fence_regs<32>(sacc);
    fence_regs<32>(pacc);
    fence_regs<OB * 4>(dvacc);
    fence_regs<OB * 4>(dkacc);
    if (i >= 1) {
      if (lane == 0) mbar_arrive(empty((i - 1) % STAGES));
      const int next = i - 1 + STAGES;
      if (threadIdx.x == 0 && next < n_items) {
        mbar_wait(empty(next % STAGES), ((i - 1) / STAGES) & 1);
        issue(next);
      }
    }
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
    if (i + 1 < n_items) issue_st(i + 1);
  }
  wg_wait<0>();
  fence_regs<OB * 4>(dvacc);
  fence_regs<OB * 4>(dkacc);

"""

N80_FROM = "__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db) {"
N80_SPLIT = """__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %13, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(d, a, db);
  wgmma_rs_n16(d + 32, a, db + ((db >> 16) & 0x3FFF));  // the next box: + the leading byte offset
}
__device__ __forceinline__ void wgmma_rs_n80_unused(float* d, const uint32_t* a, uint64_t db) {"""


def between(text: str, start: str, end: str, new: str) -> str:
    """``text`` with the first span from ``start`` up to (not including)
    ``end`` replaced by ``new``."""
    i = text.index(start)
    return text[:i] + new + text[text.index(end, i):]


def drop_line(start: str):
    """An edit that drops the one line starting (after its indent) with ``start``."""
    def edit(text: str) -> str:
        lines = text.splitlines(keepends=True)
        kept = [ln for ln in lines if not ln.lstrip().startswith(start)]
        assert len(kept) == len(lines) - 1, f"one line starts with {start!r}"
        return "".join(kept)
    return edit


# name -> {file in csrc: edit}
VARIANTS = {
    "fwd_overlap": {f"{FWD}.cu": lambda t: between(t, FWD_LOOP_FROM, FWD_LOOP_TO, FWD_OVERLAP)},
    "bwd_overlap": {f"{BWD}.cu": lambda t: between(t, BWD_LOOP_FROM, BWD_LOOP_TO, BWD_OVERLAP)},
    "n80_split": {HOPPER: lambda t: t.replace(N80_FROM, N80_SPLIT)},
    "no_hd80": {f"{FWD}.cu": drop_line("case 80: return launch_wgmma<80>"),
                f"{BWD}.cu": drop_line("case 80: return launch<80>")},
}


def compile_lib(src: Path, out: Path) -> tuple[float, str, int]:
    t = time.perf_counter()
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    return time.perf_counter() - t, r.stdout + r.stderr, r.returncode


def build_variant(name: str, work: Path) -> dict:
    """Compile the variant's libraries (each wgmma source, with the edited
    file) in turns with the library's own sources: library, variant,
    variant, library. Returns {lib: ctypes handle}."""
    edits = VARIANTS[name]
    vdir, bdir = work / name, work / "library"
    for d in (vdir, bdir):
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cu*"):
            shutil.copy(f, d / f.name)
    for fname, edit in edits.items():
        text = (_build.CSRC / fname).read_text()
        new = edit(text)
        if new == text:
            raise SystemExit(f"variant {name}: the edit of {fname} no longer applies")
        (vdir / fname).write_text(new)
    libs = [FWD, BWD] if HOPPER in edits else [f[:-3] for f in edits]
    handles, secs = {}, {}
    for lib in libs:
        for who in ("library", name, name, "library"):
            d = bdir if who == "library" else vdir
            s, log, rc = compile_lib(d / f"{lib}.cu", d / f"lib{lib}.so")
            if rc:
                raise SystemExit(f"variant {name}: nvcc failed on {lib}.cu\n{log[-3000:]}")
            secs.setdefault((lib, who), []).append(s)
            if who == name:
                summary = ptxas_summary(log, "Li80E")
        print(f"[{name}] nvcc {lib}.cu: library " + " / ".join(
            f"{s:.1f}" for s in secs[(lib, 'library')]) + f" s, {name} " + " / ".join(
            f"{s:.1f}" for s in secs[(lib, name)]) + " s", flush=True)
        for line in summary:
            if "wgmma" in line.split(":")[0]:
                print(f"[{name}] ptxas: {line}", flush=True)
        h = ctypes.CDLL(str(vdir / f"lib{lib}.so"))
        for fn, (rt, at) in _build._SIGNATURES[lib].items():
            f = getattr(h, fn)
            f.restype, f.argtypes = rt, at
        handles[lib] = h
    return handles


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


HOLD_CASES = [(2, 8, 8, 1000, 1000, True, 0, 0.0), (1, 8, 4, 300, 700, False, 0, 0.0),
              (1, 8, 4, 700, 700, True, 100, 30.0), (1, 4, 2, 300, 40, True, 8, 0.0)]


def holds(name: str, mk) -> None:
    """The variant (swapped in) against the plain version: the forward at
    3e-2 per element and 1e-2 per row, the backward by grad_check, twice
    the same bits."""
    for b, h, hkv, s, t, causal, window, cap in HOLD_CASES:
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v, do = mk(b, h, s, 80), mk(b, hkv, t, 80), mk(b, hkv, t, 80), mk(b, h, s, 80)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        ok = row_rel_err(got, want) <= 1e-2 and bool(
            ((got.float() - want.float()).abs() <= 3e-2 * (1 + want.float().abs())).all())
        grads = fa.flash_attention_bwd_cuda(q, k, v, do, **kw)
        res = [grad_check(g, w) for g, w in zip(grads, fa.flash_attention_bwd_plain(q, k, v, do,
                                                                                   **kw))]
        same = all(torch.equal(x, y) for x, y in
                   zip(grads, fa.flash_attention_bwd_cuda(q, k, v, do, **kw)))
        print(f"[{name}] holds {b}x{h}/{hkv} S={s} T={t} {kw}: forward rows "
              f"{row_rel_err(got, want):.2e} ok={ok}; backward " + " ".join(
                  f"{r['scaled_err']:.2e}/{r['row_rel']:.2e}" for r in res)
              + f" ok={all(r['ok'] for r in res)}, repeat bitwise={same}", flush=True)
        if not (ok and all(r["ok"] for r in res) and same):
            raise SystemExit(f"variant {name} does not hold")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_hd80_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
    base = {lib: _build.load(lib) for lib in (FWD, BWD)}
    q4, k4, v4 = mk(4, 32, 4096, 80), mk(4, 32, 4096, 80), mk(4, 32, 4096, 80)
    q2, k2, v2, do2 = (mk(4, 32, 2048, 80) for _ in range(4))
    _, st2 = fa.flash_attention_cuda(q2, k2, v2, return_stats=True)
    timed = {FWD: lambda: fa.flash_attention_cuda(q4, k4, v4),
             BWD: lambda: fa.flash_attention_bwd_cuda(q2, k2, v2, do2, stats=st2)}
    with tempfile.TemporaryDirectory() as work:
        for name in names:
            handles = build_variant(name, Path(work))
            if name == "no_hd80":
                continue
            _build._libs.update(handles)
            try:
                holds(name, mk)
            finally:
                _build._libs.update(base)
            for lib in handles:
                times = {"A": [], "B": []}
                for who in "ABBAAB":
                    _build._libs[lib] = base[lib] if who == "A" else handles[lib]
                    times[who].append(cuda_ms(timed[lib]))
                _build._libs[lib] = base[lib]
                what = "forward 4 x 4096" if lib == FWD else "backward 4 x 2048"
                print(f"[{name}] {what} (H = Hkv = 32, hd 80, causal): library "
                      + " / ".join(f"{t:.3f}" for t in times["A"]) + f" ms, {name} "
                      + " / ".join(f"{t:.3f}" for t in times["B"]) + " ms (A B B A A B)",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
