"""The port's CUDA kernels against their plain versions (needs a GPU).

Every test here is marked ``cuda`` and skips without a CUDA device. Run on
a GPU machine with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are built from ``src/repro_torch/csrc`` on first use. This file
imports only the port, so it runs where jax is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import KernelParams, SBVConfig, preprocess  # noqa: E402
from repro_torch.core import predict as tpredict  # noqa: E402
from repro_torch.core import vecchia  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.sbv_loglik import sbv_loglik_cuda, sbv_loglik_plain  # noqa: E402
from repro_torch.kernels.sbv_predict import sbv_predict_cuda, sbv_predict_plain  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(n=800, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, d)), rng.normal(size=n), np.linspace(0.3, 1.5, d)


def _params(beta, device):
    return KernelParams.create(sigma2=1.3, beta=beta, nugget=1e-2, device=device)


def _cast(ts, dtype):
    return tuple(t.to(dtype) if t.is_floating_point() else t for t in ts)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_loglik_kernel_matches_plain(dev, nu, dtype):
    x, y, beta = _data()
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=20, m=30))
    p = _params(beta, dev)
    arrs = vecchia.packed_arrays(packed, dev)
    want = sbv_loglik_plain(p.beta, p.sigma2, p.nugget, *arrs, nu=nu)
    before = _build.LAUNCHES["sbv_loglik"]
    got = sbv_loglik_cuda(*_cast((p.beta, p.sigma2, p.nugget), dtype), *_cast(arrs, dtype),
                          nu=nu)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sbv_loglik"] == before + 1
    assert got.dtype == dtype
    if dtype == torch.float64:
        # nu = 0.5: the kernel's distance of a point to itself is exactly 0
        # (norm and dot product summed in the same order); the plain version
        # takes the dot product from a matmul, which rounds it to ~1e-16,
        # sqrt lifts that to r ~ 1e-8, and exp(-r) passes it on (~1e-7 in
        # the likelihood). The smoother kernels are flat at r = 0.
        torch.testing.assert_close(got, want, rtol=1e-6 if nu == 0.5 else 1e-9, atol=0)
    np.testing.assert_allclose(float(got.double().sum()), float(want.sum()), rtol=5e-4)


def test_loglik_gradient_matches_plain_autograd(dev):
    x, y, beta = _data(seed=1)
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=20, m=30))
    arrs = vecchia.packed_arrays(packed, dev)
    p = _params(beta, dev)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in p]
        return torch.autograd.grad(fn(KernelParams(*leaves)), leaves)

    g_kernel = grads(lambda q: ops.sbv_loglik(q, *arrs, chunk=7))
    g_plain = grads(lambda q: vecchia.batched_block_loglik(q, *arrs))
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_predict_kernel_matches_plain(dev, dtype):
    x, y, beta = _data(seed=2)
    xt = np.random.default_rng(3).uniform(size=(150, 4))
    index = tpredict.build_train_index(x, y, beta, m_pred=40)
    packed = tpredict.pack_queries(index, xt, bs_pred=6, m_pred=40)
    p = _params(beta, dev)
    arrs = tuple(torch.as_tensor(a).to(dev) for a in packed.arrays())
    want = sbv_predict_plain(p.beta, p.sigma2, p.nugget, *arrs)
    got = sbv_predict_cuda(*_cast((p.beta, p.sigma2, p.nugget), dtype), *_cast(arrs, dtype))
    msk = torch.as_tensor(packed.q_mask, device=dev)
    # f64: rtol 1e-10 (tests/test_predict_packed.py). f32: the solve moves
    # by up to eps32 * cond(K_NN) of the output scale, so hold it to ten
    # times that.
    k_nn = vecchia._masked_cov(arrs[2], arrs[2], arrs[4], arrs[4], p.beta, p.sigma2, p.nugget,
                               3.5, identity=True)
    ev = torch.linalg.eigvalsh(k_nn)
    cond = float((ev[:, -1] / ev[:, 0]).max())
    scale = max(1.0, max(float(w[msk].abs().max()) for w in want))
    tol = 1e-10 if dtype == torch.float64 else 10 * torch.finfo(dtype).eps * cond
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double()[msk], w[msk], rtol=tol, atol=tol * scale)


def test_entry_points_run_on_cuda_and_match_cpu(dev):
    from repro_torch.core.fit import fit_sbv

    x, y, beta = _data(n=600, seed=4)
    cfg = SBVConfig(n_blocks=20, m=16)
    init = KernelParams.create(sigma2=1.0, beta=0.5, nugget=1e-2, d=4)
    ops.reset_launch_counts()
    on_gpu = fit_sbv(x, y, cfg, init=init, inner_steps=3, outer_rounds=2)
    assert ops.launch_counts()["sbv_loglik"] == 6
    on_cpu = fit_sbv(x, y, cfg, init=init, inner_steps=3, outer_rounds=2, device="cpu")
    np.testing.assert_allclose([h[2] for h in on_gpu.history],
                               [h[2] for h in on_cpu.history], rtol=1e-6)
    xt = np.random.default_rng(5).uniform(size=(90, 4))
    kw = dict(bs_pred=5, m_pred=24, n_sims=50, chunk_size=40)
    a = tpredict.predict_sbv(on_cpu.params, x, y, xt, **kw)
    assert ops.launch_counts()["sbv_predict"] == 3
    b = tpredict.predict_sbv(on_cpu.params, x, y, xt, device="cpu", **kw)
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(a.var, b.var, rtol=1e-9, atol=1e-12)
