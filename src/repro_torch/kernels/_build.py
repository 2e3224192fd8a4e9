"""Build and load the CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. The library name carries a hash of the sources and flags, so a
changed source never loads a stale build. Sources are compiled in
parallel, one ``nvcc`` each. A failed build raises; nothing falls back to
the plain versions.

The build directory is ``src/repro_torch/csrc/build`` (listed in
``.gitignore``), or ``$REPRO_TORCH_BUILD_DIR`` when set.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("sbv_loglik", "sbv_predict", "sbv_multi_stats", "matern_cov", "flash_attention",
           "flash_attention_bwd")
# The libraries: one per kernel, and the backward's wgmma route, whose
# launches count as the backward's (``flash_attention_bwd``).
LIBRARIES = KERNELS + ("flash_attention_bwd_wgmma",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

# The GP kernels' bf16-assembly variants (bf16 coordinates, f32 working
# type), built from the same sources and counted apart.
BF16_VARIANTS = tuple(f"{name}_bf16" for name in KERNELS[:4])

_lock = threading.Lock()
# Launches of each kernel and variant, counted by its wrapper where it launches.
LAUNCHES = {name: 0 for name in KERNELS + BF16_VARIANTS}
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", CSRC / "build"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict:
    """Compile the kernels that are not built yet, all at once.

    Returns ``{name: path}``. With ``verbose`` the compiler's output
    (``-Xptxas=-v``: registers, shared memory, spills) is printed."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in LIBRARIES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, cmd)
    failed = []
    for n, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {n}]\n{log}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "sbv_loglik": {
        **{f"{pre}_{v}": (_I, [_VP] * 10 + [_I] * 6 + [_VP])
           for pre in ("sbv_loglik", "sbv_loglik_panel") for v in ("f64", "f32", "bf16")},
        "sbv_loglik_scratch_per_cta": (_LL, [_I, _I]),
        **{f"{pre}_smem_bytes": (_LL, [_I, _I, _I, _I])
           for pre in ("sbv_loglik", "sbv_loglik_panel")},
        **{f"{pre}_ctas_per_sm": (_I, [_I, _I, _I, _I])
           for pre in ("sbv_loglik", "sbv_loglik_panel")},
    },
    "sbv_predict": {
        **{f"sbv_predict_{v}": (_I, [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _LL, _I, _VP])
           for v in ("f64", "f32", "bf16")},
        **{f"sbv_predict_panel_{v}": (_I, [_VP] * 10 + [_I] * 6 + [_VP])
           for v in ("f64", "f32", "bf16")},
        "sbv_predict_scratch_per_cta": (_LL, [_I, _I]),
        **{f"{pre}_smem_bytes": (_LL, [_I, _I, _I, _I])
           for pre in ("sbv_predict", "sbv_predict_panel")},
        **{f"{pre}_ctas_per_sm": (_I, [_I, _I, _I, _I])
           for pre in ("sbv_predict", "sbv_predict_panel")},
    },
    "sbv_multi_stats": {
        **{f"{pre}_{v}": (_I, [_VP] * 10 + [_I] * 7 + [_VP])
           for pre in ("sbv_multi_stats", "sbv_multi_stats_panel")
           for v in ("f64", "f32", "bf16")},
        "sbv_multi_stats_scratch_per_cta": (_LL, [_I, _I, _I]),
        **{f"{pre}_smem_bytes": (_LL, [_I] * 5)
           for pre in ("sbv_multi_stats", "sbv_multi_stats_panel")},
        **{f"{pre}_ctas_per_sm": (_I, [_I] * 5)
           for pre in ("sbv_multi_stats", "sbv_multi_stats_panel")},
    },
    "matern_cov": {
        **{f"{pre}_{v}": (_I, [_VP] * 5 + [_I] * 5 + [_VP])
           for pre in ("matern_cov", "matern_cov_rowwise") for v in ("f64", "f32", "bf16")},
        "matern_cov_ctas_per_sm": (_I, [_I, _I]),
    },
    "flash_attention": {
        fn: (_I, [_VP] * 5 + [_I] * 6 + [_PLL, _I, _I, _F, _F, _VP])
        for fn in ("flash_attention_f32", "flash_attention_wgmma_bf16",
                   "flash_attention_mma_bf16", "flash_attention_scalar_bf16")
    },
    "flash_attention_bwd": {
        fn: (_I, [_VP] * 8 + [_I] * 6 + [_PLL, _I, _I, _F, _F, _VP])
        for fn in ("flash_attention_bwd_f32", "flash_attention_bwd_bf16")
    },
    "flash_attention_bwd_wgmma": {
        "flash_attention_bwd_wgmma_bf16": (_I, [_VP] * 9 + [_I] * 6 + [_PLL, _I, _I, _F, _F, _VP]),
    },
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (one of ``LIBRARIES``), built (with its
    siblings) on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        paths = build()
        for n, p in paths.items():
            if n in _libs:
                continue
            handle = ctypes.CDLL(str(p))
            for fn, (restype, argtypes) in _SIGNATURES[n].items():
                f = getattr(handle, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[n] = handle
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
