"""The port stands alone: no jax, no ``repro``, no quiet CPU fallback."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


def test_import_leaves_jax_and_repro_out():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_imports_jax_or_repro():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if IMPORT_RE.search(f.read_text())]
    assert not offenders, offenders


def test_import_leaves_ml_dtypes_out():
    """The card's machine has no ml_dtypes: the port's bf16 tier stores its
    coordinates as torch.bfloat16 tensors, and no module pulls it in."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "assert 'ml_dtypes' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_imports_ml_dtypes():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import|from)\s+ml_dtypes\b|import_module\([\"']ml_dtypes", re.M)
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def _tiny():
    rng = np.random.default_rng(0)
    return rng.uniform(size=(40, 2)), rng.normal(size=40)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_device_when_no_cuda(monkeypatch):
    from repro_torch.core import SBVConfig, KernelParams
    from repro_torch.core.fit import fit_sbv
    from repro_torch.core.predict import predict_sbv

    _no_cuda(monkeypatch)
    x, y = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_sbv(x, y, SBVConfig(n_blocks=4, m=4), inner_steps=1, outer_rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_sbv(KernelParams.create(beta=[0.5, 0.5]), x, y, x[:5], bs_pred=2, m_pred=4)


@pytest.mark.parametrize("kw", [{"stream_chunk": 10, "multihost": object(), "n_buckets": 2},
                                {"stream_chunk": 10, "tuning": object()},
                                {"tuning": object()},
                                {"stream_chunk": 10, "multihost": object(), "tuning": object()}])
def test_unported_options_raise(kw):
    """Options the port does not take raise ``NotImplementedError``; tuning
    records are ported, and a ``tuning`` that is no record raises
    ``TypeError`` before any work starts."""
    from repro_torch.core import SBVConfig
    from repro_torch.core.fit import fit_sbv

    x, y = _tiny()
    exc = TypeError if "tuning" in kw else NotImplementedError
    with pytest.raises(exc):
        fit_sbv(x, y, SBVConfig(n_blocks=4, m=4), device="cpu", **kw)


def test_kernel_wrappers_never_run_the_plain_version_for_cuda(monkeypatch):
    """Without CUDA, a kernel wrapper asked for the kernel raises; it does
    not hand back the plain version's numbers."""
    from repro_torch.kernels import _build, sbv_loglik, sbv_predict

    calls = []
    before = dict(_build.LAUNCHES)
    monkeypatch.setattr(sbv_loglik, "block_loglik", lambda *a, **k: calls.append(a))
    x = torch.zeros(2, 3, 2, dtype=torch.float64)
    m = torch.ones(2, 3, dtype=torch.float64)
    b = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        sbv_loglik.sbv_loglik_cuda(b, b[0], b[0], x, m, m, x, m, m)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        sbv_predict.sbv_predict_cuda(b, b[0], b[0], x, m, x, m, m)
    assert not calls
    assert _build.LAUNCHES == before
    # The build itself refuses without a CUDA toolkit instead of skipping.
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
