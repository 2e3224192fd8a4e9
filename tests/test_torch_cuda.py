"""The port's CUDA kernels against their plain versions (needs a GPU).

Every test here is marked ``cuda`` and skips without a CUDA device. Run on
a GPU machine with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are built from ``src/repro_torch/csrc`` on first use. This file
imports only the port (and the checks it shares with ``chip_smoke.py``), so
it runs where jax is not installed.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import KernelParams, SBVConfig, preprocess  # noqa: E402
from repro_torch.core import exact_gp as texact  # noqa: E402
from repro_torch.core import kl as tkl  # noqa: E402
from repro_torch.core import multioutput as mo  # noqa: E402
from repro_torch.core import predict as tpredict  # noqa: E402
from repro_torch.core import vecchia  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (ROUTES, _kernel_ready,  # noqa: E402
                                                 flash_attention_cuda, flash_attention_plain,
                                                 flash_route)
from repro_torch.kernels.flash_attention import _launch as flash_launch  # noqa: E402
from repro_torch.kernels.matern_cov import _launch as cov_launch  # noqa: E402
from repro_torch.kernels.matern_cov import matern_cov_cuda, matern_cov_plain  # noqa: E402
from repro_torch.kernels.sbv_loglik import _launch as loglik_launch  # noqa: E402
from repro_torch.kernels.sbv_loglik import sbv_loglik_cuda, sbv_loglik_plain  # noqa: E402
from repro_torch.kernels.sbv_multi_stats import _launch as multi_launch  # noqa: E402
from repro_torch.kernels.sbv_multi_stats import (sbv_multi_stats_cuda,  # noqa: E402
                                                 sbv_multi_stats_plain)
from repro_torch.kernels.sbv_predict import _launch_panel as predict_panel  # noqa: E402
from repro_torch.kernels.sbv_predict import (sbv_predict_cuda, sbv_predict_cuda_many,  # noqa: E402
                                             sbv_predict_plain)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import cond_bound, f32_cov_check  # noqa: E402

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
        # Every nu at 1e-9: the kernel's distance of a point to itself is
        # exactly 0 (norm and dot product summed in the same order), and the
        # plain version sets it to 0 too (ROADMAP fault 1, repaired).
        torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
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


def _loglik_case(case, dev):
    """Packed arrays for a (bs, m, bc) cut of real blocks. 'wide' blocks
    (P = bs + m > 256) take more than one pass of the factorization's 256
    rows; 'holes' masks every third point inside the prefix of real ones."""
    kind, bs, m, bc = case
    if kind == "wide":
        x, y, beta = _data(n=3000, seed=8)
        packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=10, m=m))
    else:
        x, y, beta = _data(seed=9)
        packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=20, m=max(m, 4)))
    arrs = [a[:bc] for a in _slice(vecchia.packed_arrays(packed, dev), bs, m)]
    if kind == "holes":
        arrs[2] = arrs[2] & (torch.arange(bs, device=dev) % 3 != 1)
        arrs[5] = arrs[5] & (torch.arange(m, device=dev) % 3 != 2)
    return tuple(arrs), beta


# (kind, bs, m, bc) of the tiled factorization's edges: P = bs + m below,
# at, one above and well above its 32-column panel (and not a multiple of
# it), the round-0 bucket with m = 4, one block, fewer blocks than the
# grid, more than 256 rows (two passes), and masked points inside a block.
LOGLIK_CASES = [("plain", 20, 4, 20), ("plain", 28, 4, 20), ("plain", 29, 4, 20),
                ("plain", 37, 29, 20), ("plain", 37, 29, 1), ("plain", 37, 29, 3),
                ("wide", 300, 40, 4), ("holes", 37, 29, 20)]


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("case", LOGLIK_CASES, ids=lambda c: "-".join(map(str, c)))
def test_loglik_tiled_kernel_edges(dev, case, nu):
    arrs, beta = _loglik_case(case, dev)
    p = _params(beta, dev)
    want = sbv_loglik_plain(p.beta, p.sigma2, p.nugget, *arrs, nu=nu)
    got = sbv_loglik_cuda(p.beta, p.sigma2, p.nugget, *arrs, nu=nu)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
    got32 = sbv_loglik_cuda(*_cast((p.beta, p.sigma2, p.nugget), torch.float32),
                            *_cast(arrs, torch.float32), nu=nu)
    np.testing.assert_allclose(float(got32.double().sum()), float(want.sum()), rtol=5e-4)
    b16 = _bf16(arrs, dev)
    par = (p.beta.float(), p.sigma2.float(), p.nugget.float())
    want16 = sbv_loglik_plain(*par, *b16, nu=nu)
    got16 = sbv_loglik_cuda(*par, *b16, nu=nu)
    assert float(((got16 - want16).abs() / want16.abs().clamp(min=1)).max()) <= BF16_TOL


@pytest.mark.parametrize("variant", ["f64", "f32", "bf16"])
def test_loglik_panel_baseline_agrees_with_tiled(dev, variant):
    """The earlier design (padded blocks, 16-column right-looking panels),
    callable for the side-by-side timing, computes the same likelihood;
    its launches are not path launches."""
    arrs, beta = _loglik_case(("plain", 37, 29, 20), dev)
    p = _params(beta, dev)
    par = (p.beta, p.sigma2, p.nugget)
    if variant == "f32":
        par, arrs = _cast(par, torch.float32), _cast(arrs, torch.float32)
    elif variant == "bf16":
        par, arrs = _cast(par, torch.float32), _bf16(arrs, dev)
    before = dict(_build.LAUNCHES)
    base = loglik_launch("sbv_loglik_panel", *par, *arrs, nu=3.5)
    assert _build.LAUNCHES == before
    got = sbv_loglik_cuda(*par, *arrs)
    rel = float(((got.double() - base.double()).abs() / base.double().abs().clamp(min=1)).max())
    # f32: two f32 eliminations in different orders, per block within
    # chip_smoke.py's f32 limit (LADDER_TOL_F32, 3e-3 of max(1, |value|)).
    assert rel <= {"f64": 1e-10, "f32": 3e-3, "bf16": BF16_TOL}[variant]


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


def _multi_data(n=900, d=4, p=3, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.stack([np.sin(x @ rng.uniform(1.0, 3.0, size=d)) + 0.01 * rng.standard_normal(n)
                  for _ in range(p)], axis=1)
    return x, y, np.linspace(0.3, 1.5, d)


def _multi_params(beta, p, device):
    return mo.MultiOutputParams.create(sigma2=np.linspace(0.5, 1.5, p), beta=beta, tau2=1e-2,
                                       d=len(beta), p=p, device=device)


def _slice(arrs, bs, m):
    bx, by, bm, nx, ny, nm = arrs
    return bx[:, :bs], by[:, :bs], bm[:, :bs], nx[:, :m], ny[:, :m], nm[:, :m]


@pytest.mark.parametrize("nu", [0.5, 3.5])
@pytest.mark.parametrize("ragged", [False, True])
def test_multi_stats_kernel_matches_plain(dev, nu, ragged):
    x, y, beta = _multi_data()
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=24, m=30))
    arrs = vecchia.packed_arrays(packed, dev)
    if ragged:
        arrs = _slice(arrs, 13, 17)
    p0 = _multi_params(beta, 3, dev).structure_params()
    want = sbv_multi_stats_plain(p0.beta, p0.sigma2, p0.nugget, *arrs, nu=nu)
    before = _build.LAUNCHES["sbv_multi_stats"]
    got = sbv_multi_stats_cuda(p0.beta, p0.sigma2, p0.nugget, *arrs, nu=nu)
    got32 = sbv_multi_stats_cuda(*_cast((p0.beta, p0.sigma2, p0.nugget), torch.float32),
                                 *_cast(arrs, torch.float32), nu=nu)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sbv_multi_stats"] == before + 2
    assert got.shape == (arrs[0].shape[0], 4) and got32.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
    # f32 against f64 on the dataset totals, the reference's 5e-4 rule.
    torch.testing.assert_close(got32.double().sum(0), want.sum(0), rtol=5e-4, atol=0)


def test_multi_stats_p1_matches_single_output_kernel(dev):
    """At p = 1, sigma2 = 1 and nugget = tau2, the single-output block
    log-density is -n/2 log 2 pi - logdet0 / 2 - q0 / 2."""
    x, y, beta = _multi_data(p=1)
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=24, m=30))
    arrs = vecchia.packed_arrays(packed, dev)
    p0 = _multi_params(beta, 1, dev).structure_params()
    stats = sbv_multi_stats_cuda(p0.beta, p0.sigma2, p0.nugget, *arrs)
    ll = sbv_loglik_cuda(p0.beta, p0.sigma2, p0.nugget, arrs[0], arrs[1][..., 0], *arrs[2:4],
                         arrs[4][..., 0], arrs[5])
    n_b = arrs[2].sum(dim=1).double()
    from_stats = -0.5 * n_b * vecchia._LOG2PI - 0.5 * stats[:, 0] - 0.5 * stats[:, 1]
    torch.testing.assert_close(from_stats, ll, rtol=1e-12, atol=0)


def test_multi_stats_gradient_matches_plain_autograd(dev):
    x, y, beta = _multi_data(seed=7)
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=24, m=30))
    arrs = vecchia.packed_arrays(packed, dev)
    p = _multi_params(beta, 3, dev)

    def grads(backend):
        leaves = [t.clone().requires_grad_(True) for t in p]
        ld, q = mo.packed_multi_stats(mo.MultiOutputParams(*leaves), packed, backend=backend,
                                      arrays=arrs)
        loss = mo.pooled_objective(ld, q, packed.n_points)
        return torch.autograd.grad(loss, leaves[1:])

    for a, b in zip(grads("auto"), grads("ref")):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=0)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("shape", [(3, 70, 90, 4), (2, 37, 61, 10), (1, 1, 129, 2)])
def test_matern_cov_kernel_matches_plain(dev, nu, shape):
    b, na, nb, d = shape
    rng = np.random.default_rng(8)
    xa = torch.as_tensor(rng.uniform(size=(b, na, d)), device=dev)
    xb = torch.as_tensor(rng.uniform(size=(b, nb, d)), device=dev)
    beta = torch.linspace(0.5, 1.5, d, dtype=torch.float64, device=dev)
    s2 = torch.tensor(0.7, dtype=torch.float64, device=dev)
    want = matern_cov_plain(xa, xb, beta, s2, nu=nu)
    before = _build.LAUNCHES["matern_cov"]
    got = matern_cov_cuda(xa, xb, beta, s2, nu=nu)
    got32 = matern_cov_cuda(xa.float(), xb.float(), beta, s2, nu=nu)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["matern_cov"] == before + 2
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(got32.double(), want, rtol=1e-5, atol=1e-5)
    # A point set against itself: the kernel's self-distance is exactly 0.
    same = matern_cov_cuda(xa, xa, beta, s2, nu=nu)
    torch.testing.assert_close(torch.diagonal(same, dim1=-2, dim2=-1),
                               torch.full((b, na), 0.7, dtype=torch.float64, device=dev),
                               rtol=1e-14, atol=0)


def test_multi_entry_points_run_on_cuda_and_match_cpu(dev):
    from repro_torch.core.fit import fit_sbv

    x, y, _ = _multi_data(n=600, seed=9)
    cfg = SBVConfig(n_blocks=20, m=16)
    ops.reset_launch_counts()
    on_gpu = fit_sbv(x, y, cfg, inner_steps=3, outer_rounds=2)
    # 2 rounds x 3 steps, and the final profile of sigma2.
    assert ops.launch_counts()["sbv_multi_stats"] == 7
    on_cpu = fit_sbv(x, y, cfg, inner_steps=3, outer_rounds=2, device="cpu")
    np.testing.assert_allclose([h[2] for h in on_gpu.history],
                               [h[2] for h in on_cpu.history], rtol=1e-6)
    xt = np.random.default_rng(10).uniform(size=(90, 4))
    kw = dict(bs_pred=5, m_pred=24, n_sims=50, chunk_size=40)
    a = tpredict.predict_sbv(on_cpu.params, x, y, xt, **kw)
    b = tpredict.predict_sbv(on_cpu.params, x, y, xt, device="cpu", **kw)
    assert a.mean.shape == (90, 3)
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(a.var, b.var, rtol=1e-9, atol=1e-12)


# The reference's flash tolerances (tests/test_flash_attention.py). bf16
# outputs of random inputs are ~0.03-0.07, about the size of 3e-2 * (1 + |o|),
# so bf16 is also held per output row in relative L2 (FLASH_ROW_TOL; the
# tensor-core kernel rounds exp(s - m) to bf16 before P . V, ~2e-3 of a row,
# at most 4.8e-3 over chip_smoke.py's cases), on random inputs and on edge
# inputs whose O(1) outputs hinge on the keys at the mask's edges.
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
FLASH_ROW_TOL = 1e-2
# (B, H, Hkv, S, T, hd, causal, window, softcap): the path's variants at a
# reduced size, and the cases where the kernel must not skip a KV tile. bf16
# at hd 64, 80 and 128 reaches the wgmma kernel (128 query rows and 128-key
# tiles per CTA), at hd 256 the 256-thread wgmma kernel (64-key tiles), at
# hd 32 the mma.sync one, f32 the scalar one (``flash_route``).
FLASH_CASES = [
    (2, 4, 2, 256, 256, 128, True, 0, 0.0),     # the path: GQA, causal
    (1, 2, 1, 1000, 1000, 128, True, 0, 0.0),   # ragged S = T = 1000
    (1, 2, 2, 64, 512, 128, False, 0, 0.0),     # not causal, S < T
    (1, 2, 1, 300, 300, 128, True, 17, 0.0),    # window 17
    (1, 2, 2, 200, 200, 128, True, 0, 50.0),    # softcap 50
    (1, 2, 2, 100, 37, 32, True, 0, 0.0),       # S > T, top-left aligned
    (1, 2, 2, 96, 16, 32, True, 8, 0.0),        # rows with no allowed key
    (1, 2, 2, 96, 16, 64, False, 8, 0.0),       # the same, not causal
    (2, 4, 2, 160, 160, 64, True, 0, 0.0),
    (2, 4, 2, 160, 160, 80, True, 0, 0.0),
    (1, 4, 2, 130, 130, 256, True, 0, 0.0),
    (1, 1, 1, 1, 1, 32, True, 0, 0.0),
    # The wgmma route: hd 64 with H = Hkv (musicgen-large); S and T one
    # below and one above the 128-row tile; S < 128 against a long T,
    # causal and not; a window that crosses tiles, with and without a
    # softcap; rows with no allowed key (causal, window, S > T).
    (1, 4, 4, 300, 300, 64, True, 0, 0.0),
    (1, 2, 1, 127, 127, 128, True, 0, 0.0),
    (1, 2, 1, 129, 129, 128, True, 0, 0.0),
    (1, 2, 1, 50, 700, 128, True, 0, 0.0),
    (1, 2, 1, 100, 900, 64, False, 0, 0.0),
    (1, 2, 1, 1000, 1000, 128, True, 200, 0.0),
    (1, 2, 2, 520, 520, 128, True, 150, 30.0),
    (1, 2, 2, 300, 40, 128, True, 8, 0.0),
]


def _flash_inputs(dev, dtype, b, h, hkv, s, t, hd, seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(dtype)
    return mk(b, h, s, hd), mk(b, hkv, t, hd), mk(b, hkv, t, hd)


def _edge_queries(k, n_heads, s, window, beta=2.0):
    """q_i = beta * (k_i + k_{i+1} [+ k_{i-window}]) on KV head h // n_rep:
    the softmax peaks on the keys at the mask's edges."""
    b, hkv, t, hd = k.shape
    kf = k.float().repeat_interleave(n_heads // hkv, dim=1)
    i = torch.arange(s, device=k.device)
    q = torch.zeros(b, n_heads, s, hd, device=k.device)
    for off in (0, 1) + ((-window,) if window > 0 else ()):
        j = i + off
        ok = (j >= 0) & (j < t)
        q[:, :, ok] += kf[:, :, j[ok]]
    return (beta * q).to(k.dtype)


def _row_rel_err(got, want):
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(dev, dtype, case):
    b, h, hkv, s, t, hd, causal, window, cap = case
    q, k, v = _flash_inputs(dev, dtype, b, h, hkv, s, t, hd)
    queries = [q] if dtype == torch.float32 else [q, _edge_queries(k, h, s, window)]
    for qq in queries:
        want = flash_attention_plain(qq, k, v, causal=causal, window=window, softcap=cap)
        before = _build.LAUNCHES["flash_attention"]
        got = flash_attention_cuda(qq, k, v, causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attention"] == before + 1
        assert got.shape == (b, h, s, hd) and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
        if dtype == torch.bfloat16:
            assert _row_rel_err(got, want) <= FLASH_ROW_TOL


def test_flash_kernel_takes_model_layout_strides(dev):
    """(B, S, H, hd) projections seen as (B, H, S, hd): no copy in, and the
    output keeps the model's layout."""
    x = torch.randn(2, 100, 4, 64, device=dev).to(torch.bfloat16)
    kv = torch.randn(2, 100, 2, 64, device=dev).to(torch.bfloat16)
    got = flash_attention_cuda(x.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(x.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2))
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(*(torch.zeros(1, 1, 4, 48, device=dev),) * 3)


def test_flash_wgmma_takes_model_layout_strides_at_hd128(dev):
    """The wgmma route reads the model's (B, S, H, hd) projections through
    its tensor maps without a copy, and writes the model's layout."""
    assert flash_route(torch.bfloat16, 128) == "wgmma"
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(2, 300, 4, 128, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(2, 300, 2, 128, generator=g, device=dev).to(torch.bfloat16)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    assert _kernel_ready(q) is q and _kernel_ready(k) is k
    got = flash_attention_cuda(q, k, k)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(q, k, k)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    assert _row_rel_err(got, want) <= FLASH_ROW_TOL


def test_flash_hd32_stays_on_the_mma_route(dev):
    """hd 32 runs the mma.sync kernel: the route says so, and the
    wrapper's output is that kernel's, bit for bit."""
    assert flash_route(torch.bfloat16, 32) == "mma"
    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 4, 2, 200, 200, 32, seed=3)
    got = flash_attention_cuda(q, k, v)
    mma = flash_launch(ROUTES["mma"], q, k, v, True, 0, 0.0)
    assert torch.equal(got, mma)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("case", [(2, 4, 2, 256, 256, 128, True, 0, 0.0),
                                  (1, 4, 4, 300, 300, 64, True, 0, 0.0),
                                  (1, 2, 1, 1000, 1000, 128, True, 200, 0.0)],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_wgmma_agrees_with_the_mma_baseline(dev, case):
    """The earlier mma.sync design, callable at hd 64 and 128 for the
    side-by-side timing, computes the same function as the wgmma route:
    both round P to bf16 before P . V, so they agree to the bf16 limits
    per output row, and neither launch counts as a path launch."""
    b, h, hkv, s, t, hd, causal, window, cap = case
    q, k, v = _flash_inputs(dev, torch.bfloat16, b, h, hkv, s, t, hd, seed=7)
    before = _build.LAUNCHES["flash_attention"]
    base = flash_launch(ROUTES["mma"], q, k, v, causal, window, cap)
    assert _build.LAUNCHES["flash_attention"] == before
    got = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), base.float(), **FLASH_TOL[torch.bfloat16])
    assert _row_rel_err(got, base) <= FLASH_ROW_TOL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_prefill_through_kernel_matches_plain_route(dev, dtype):
    """A reduced-depth internlm2 at full width: the prefill launches the
    kernel once per layer and none in decode, and agrees with the
    ``use_flash="never"`` route. In f32 the two routes compute the same
    function in other orders (1e-4). In bf16 the two routes round
    different numbers (the kernel the unnormalised exp(s - m_running)
    before P . V, the never route the normalised P), and at d_model = 2048
    a few logits move by more than the reference's reduced-size 3e-2
    (tests/test_flash_integration.py), with both routes about equally far
    from the f32 model. So bf16 is held to 3e-2 in relative L2 norm, and
    elementwise the kernel route may be no further from the same weights
    in f32 than 1.25x the never route's largest error."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import TransformerLM, init_params, prefill_step
    from repro_torch.training.serve import greedy_generate

    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2, dtype=dtype)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    never = TransformerLM(dataclasses.replace(cfg, use_flash="never"), device="meta")
    never.load_state_dict(model.state_dict(), assign=True)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 300)),
                             dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    with torch.inference_mode():
        a, _ = prefill_step(model, prompt, 310)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers
        b, _ = prefill_step(never, prompt, 310)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    if dtype == "float32":
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    else:
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 3e-2
        m32 = TransformerLM(dataclasses.replace(cfg, dtype="float32"), device="meta")
        m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, assign=True)
        with torch.inference_mode():
            c, _ = prefill_step(m32, prompt, 310)
        assert float((a - c).abs().max()) <= 1.25 * float((b - c).abs().max())
    ops.reset_launch_counts()
    toks = greedy_generate(model, prompt, cfg, 4, 310)
    assert toks.shape == (2, 4) and ops.launch_counts()["flash_attention"] == cfg.n_layers


# -- the bf16-assembly variants (bf16 coordinates, f32 working type) ---------
#
# Each bf16 variant is held to its plain version (vecchia.block_loglik_narrow,
# multioutput.block_multi_stats_narrow, predict.block_predict_narrow,
# matern_cov_plain on bf16): both round the scaled coordinates to the same
# bf16 values, then assemble, factor and solve in f32 in different orders.
# Measured on the CPU on these inputs, the plain version's f32 error against
# the same bf16-assembly math in f64 reaches 5e-4 relative per block (loglik),
# 4e-4 (q of multi-stats) and 1e-3 absolute on means of size 2 (predict), so
# two f32 evaluations are held to 2e-3 of max(1, |value|) per block, and
# predictions to 3e-3 of max(1, output scale). The covariance is held at the
# f32 kernel's 1e-5.
BF16_TOL, BF16_PRED_TOL = 2e-3, 3e-3


def _bf16_case(d, floor, n=800, p=None):
    """Packed blocks at d, with a ragged bs and m (sliced to 37 and 29), and
    parameters whose nugget is below the bf16 pivot floor 2^-7 * sigma2
    (``floor``) or above it."""
    rng = np.random.default_rng(20 + d)
    x = rng.uniform(size=(n, d))
    y = rng.normal(size=n) if p is None else rng.normal(size=(n, p))
    beta = np.linspace(0.3, 1.5, d)
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=20, m=30))
    nugget = 1e-4 if floor else 1e-2
    return packed, beta, nugget


def _bf16(arrs, dev):
    bx, by, bm, nx, ny, nm = (a.to(dev) for a in arrs)
    return bx.bfloat16(), by.float(), bm, nx.bfloat16(), ny.float(), nm


def _floor_engaged(fn, monkeypatch):
    """Whether the bf16 pivot floor changes ``fn()`` (plain version) by more
    than f32 rounding: run it again with the floor at 1e-20."""
    with_floor = fn()
    monkeypatch.setattr(vecchia, "BF16_EPS", 1e-20)
    without = fn()
    monkeypatch.undo()
    w = with_floor if isinstance(with_floor, torch.Tensor) else with_floor[0]
    wo = without if isinstance(without, torch.Tensor) else without[0]
    return bool(((w - wo).abs() > 1e-2 * w.abs().clamp(min=1)).any())


@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("d", [3, 10])
def test_loglik_bf16_variant_matches_plain(dev, d, floor, monkeypatch):
    packed, beta, nugget = _bf16_case(d, floor)
    arrs = _bf16(_slice(vecchia.packed_arrays(packed, "cpu"), 37, 29), dev)
    par = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in (beta, 1.3, nugget))
    plain = lambda: sbv_loglik_plain(*par, *arrs)
    assert _floor_engaged(plain, monkeypatch) == floor
    want = plain()
    before = dict(_build.LAUNCHES)
    got = sbv_loglik_cuda(*par, *arrs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sbv_loglik_bf16"] == before["sbv_loglik_bf16"] + 1
    assert _build.LAUNCHES["sbv_loglik"] == before["sbv_loglik"]
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert float(((got - want).abs() / want.abs().clamp(min=1)).max()) <= BF16_TOL


@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("d", [3, 10])
def test_multi_stats_bf16_variant_matches_plain(dev, d, floor, monkeypatch):
    packed, beta, nugget = _bf16_case(d, floor, p=3)
    arrs = _bf16(_slice(vecchia.packed_arrays(packed, "cpu"), 37, 29), dev)
    par = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in (beta, 1.0, nugget))
    plain = lambda: sbv_multi_stats_plain(*par, *arrs)
    assert _floor_engaged(plain, monkeypatch) == floor
    want = plain()
    before = _build.LAUNCHES["sbv_multi_stats_bf16"]
    got = sbv_multi_stats_cuda(*par, *arrs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sbv_multi_stats_bf16"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(((got - want).abs() / want.abs().clamp(min=1)).max()) <= BF16_TOL


@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("d", [3, 10])
def test_predict_bf16_variant_matches_plain(dev, d, floor, monkeypatch):
    rng = np.random.default_rng(30 + d)
    x, y = rng.uniform(size=(800, d)), rng.normal(size=800)
    beta = np.linspace(0.3, 1.5, d)
    index = tpredict.build_train_index(x, y, beta, m_pred=41)
    packed = tpredict.pack_queries(index, rng.uniform(size=(150, d)), bs_pred=7, m_pred=41)
    q_x, q_mask, nn_x, nn_y, nn_mask = (torch.as_tensor(a).to(dev) for a in packed.arrays())
    arrs = (q_x.bfloat16(), q_mask, nn_x.bfloat16(), nn_y.float(), nn_mask)
    par = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in (beta, 1.3, 1e-5 if floor else 1e-2))
    plain = lambda: sbv_predict_plain(*par, *arrs)
    assert _floor_engaged(plain, monkeypatch) == floor
    want = plain()
    before = _build.LAUNCHES["sbv_predict_bf16"]
    got = sbv_predict_cuda(*par, *arrs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sbv_predict_bf16"] == before + 1
    scale = max(1.0, max(float(w[q_mask].abs().max()) for w in want))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g - w)[q_mask].abs().max()) <= BF16_PRED_TOL * scale


@pytest.mark.parametrize("shape", [(3, 70, 90, 3), (2, 37, 61, 10)])
def test_matern_cov_bf16_variant_matches_plain(dev, shape):
    b, na, nb, d = shape
    rng = np.random.default_rng(8)
    xa = torch.as_tensor(rng.uniform(size=(b, na, d)), device=dev).bfloat16()
    xb = torch.as_tensor(rng.uniform(size=(b, nb, d)), device=dev).bfloat16()
    kp = KernelParams.create(sigma2=0.7, beta=np.linspace(0.3, 1.5, d), device=dev)
    want = matern_cov_plain(xa, xb, kp.beta.float(), kp.sigma2.float())
    before = _build.LAUNCHES["matern_cov_bf16"]
    got = ops.matern_cov(xa, xb, kp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["matern_cov_bf16"] == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _unrounded(how):
    """The plain versions' scaled coordinates with one rounding left out:
    bf16(x / beta) ('beta') or x / bf16(beta) in f32 ('z')."""
    if how == "beta":
        return lambda x, b: (x.float() / b.float()).to(x.dtype).float()
    return lambda x, b: x.float() / b.to(x.dtype).float()


@pytest.mark.parametrize("kernel", ["sbv_loglik", "sbv_multi_stats", "sbv_predict",
                                    "matern_cov"])
def test_bf16_variants_round_the_scaled_coordinates(dev, kernel, monkeypatch):
    """Each bf16 variant computes z = bf16(x / bf16(beta)), as its plain
    version does: at betas bf16 cannot hold, the kernel is closer (in L2) to
    its plain version than half its distance to the plain version without
    the beta rounding, and to the one without the rounding of x / beta. (A
    per-block limit cannot tell these apart where the roundings are exact,
    as at beta = 0.5.)"""
    d = 10
    beta = np.linspace(0.31, 1.43, d)  # no entry is a bf16 number
    par = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in (beta, 1.3, 1e-2))
    if kernel == "sbv_predict":
        rng = np.random.default_rng(40)
        x, y = rng.uniform(size=(800, d)), rng.normal(size=800)
        index = tpredict.build_train_index(x, y, beta, m_pred=41)
        packed = tpredict.pack_queries(index, rng.uniform(size=(150, d)), bs_pred=7, m_pred=41)
        q_x, q_mask, nn_x, nn_y, nn_mask = (torch.as_tensor(a).to(dev) for a in packed.arrays())
        arrs = (q_x.bfloat16(), q_mask, nn_x.bfloat16(), nn_y.float(), nn_mask)
        run_k, run_p = (lambda: sbv_predict_cuda(*par, *arrs)), \
            (lambda: sbv_predict_plain(*par, *arrs))
    elif kernel == "matern_cov":
        rng = np.random.default_rng(41)
        xa = torch.as_tensor(rng.uniform(size=(2, 37, d)), device=dev).bfloat16()
        xb = torch.as_tensor(rng.uniform(size=(2, 61, d)), device=dev).bfloat16()
        run_k, run_p = (lambda: matern_cov_cuda(xa, xb, par[0], par[1])), \
            (lambda: matern_cov_plain(xa, xb, par[0], par[1]))
    else:
        packed, _, _ = _bf16_case(d, False, p=3 if kernel == "sbv_multi_stats" else None)
        arrs = _bf16(vecchia.packed_arrays(packed, "cpu"), dev)
        pk = par if kernel == "sbv_loglik" else (par[0], torch.ones_like(par[1]), par[2])
        fns = {"sbv_loglik": (sbv_loglik_cuda, sbv_loglik_plain),
               "sbv_multi_stats": (sbv_multi_stats_cuda, sbv_multi_stats_plain)}[kernel]
        run_k, run_p = (lambda: fns[0](*pk, *arrs)), (lambda: fns[1](*pk, *arrs))
    flat = lambda o: torch.cat([t.double().reshape(-1)
                                for t in (o if isinstance(o, tuple) else (o,))])
    from repro_torch.kernels import matern_cov as mc

    got = flat(run_k())
    torch.cuda.synchronize()
    dist = {}
    for how in (None, "beta", "z"):
        if how is not None:
            monkeypatch.setattr(vecchia, "narrow_scaled", _unrounded(how))
            monkeypatch.setattr(mc, "narrow_scaled", _unrounded(how))
        dist[how] = float(torch.linalg.vector_norm(got - flat(run_p())))
        monkeypatch.undo()
    assert dist[None] <= 0.5 * min(dist["beta"], dist["z"]), dist


# -- prediction and multi-output stats on the tiled core ---------------------
#
# (kind, bs, m, bc): P = m + bs below, at, one above and well above the
# 32-column panel, m = 4 (the round-0 small bucket), one block, more than
# 256 rows (two passes), and 'holes': every third point masked in both
# sets, block 1 with every query (block point) masked, block 2 with no
# real neighbour.
PREDICT_CASES = [("plain", 6, 20, 20), ("plain", 8, 24, 20), ("plain", 9, 24, 20),
                 ("plain", 25, 70, 20), ("plain", 7, 4, 20), ("plain", 25, 40, 1),
                 ("wide", 30, 240, 4), ("holes", 25, 70, 20)]
MULTI_CASES = [("plain", 14, 10, 20), ("plain", 22, 10, 20), ("plain", 23, 10, 20),
               ("plain", 37, 29, 20), ("plain", 20, 4, 20), ("plain", 37, 29, 1),
               ("wide", 300, 40, 4), ("holes", 37, 29, 20)]


def _punch(arrs, i_first, i_second, dev):
    """'holes': every third point of both sets masked, set one of block 1
    and set two of block 2 masked whole."""
    a, b = arrs[i_first], arrs[i_second]
    a = a & (torch.arange(a.shape[1], device=dev) % 3 != 1)
    b = b & (torch.arange(b.shape[1], device=dev) % 3 != 2)
    a[1], b[2] = False, False
    arrs[i_first], arrs[i_second] = a, b
    return arrs


def _predict_case(case, dev):
    kind, bs, m, bc = case
    x, y, beta = _data(n=3000 if kind == "wide" else 800, seed=13)
    xt = np.random.default_rng(14).uniform(size=(max(150, 8 * bs), 4))
    index = tpredict.build_train_index(x, y, beta, m_pred=m)
    packed = tpredict.pack_queries(index, xt, bs_pred=bs, m_pred=m)
    q_x, q_m, nn_x, nn_y, nn_m = (torch.as_tensor(a).to(dev)[:bc] for a in packed.arrays())
    arrs = [q_x[:, :bs], q_m[:, :bs], nn_x, nn_y, nn_m]
    if kind == "holes":
        arrs = _punch(arrs, 1, 4, dev)
    return tuple(arrs), beta


def _multi_case(case, dev):
    kind, bs, m, bc = case
    if kind == "wide":
        x, y, beta = _multi_data(n=3000, seed=15)
        packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=10, m=m))
    else:
        x, y, beta = _multi_data(seed=16)
        packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=24, m=max(m, 4)))
    arrs = [a[:bc] for a in _slice(vecchia.packed_arrays(packed, dev), bs, m)]
    if kind == "holes":
        arrs = _punch(arrs, 2, 5, dev)
    return tuple(arrs), beta


def _pred_err(got, want):
    """Largest error of (mu, var) over every slot, and the output scale."""
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want)), scale


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("case", PREDICT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_predict_tiled_kernel_edges(dev, case, nu):
    arrs, beta = _predict_case(case, dev)
    p = _params(beta, dev)
    par = (p.beta, p.sigma2, p.nugget)
    want = sbv_predict_plain(*par, *arrs, nu=nu)
    got = sbv_predict_cuda(*par, *arrs, nu=nu)
    err, scale = _pred_err(got, want)
    assert err <= 1e-9 * scale
    if case[0] == "holes":  # all queries masked / no real neighbour: mu 0, var the prior
        prior = float(p.sigma2 + p.nugget)
        for b in (1, 2):
            assert bool((got[0][b] == 0).all()) and bool((got[1][b] == prior).all())
    # f32: the solve moves by up to eps32 * cond(K_NN) of the output scale.
    k_nn = vecchia._masked_cov(arrs[2], arrs[2], arrs[4], arrs[4], *par, nu, identity=True)
    ev = torch.linalg.eigvalsh(k_nn)
    cond = float((ev[:, -1] / ev[:, 0]).max())
    got32 = sbv_predict_cuda(*_cast(par, torch.float32), *_cast(arrs, torch.float32), nu=nu)
    assert _pred_err(got32, want)[0] <= 10 * torch.finfo(torch.float32).eps * cond * scale
    b16 = (arrs[0].bfloat16(), arrs[1], arrs[2].bfloat16(), arrs[3].float(), arrs[4])
    par16 = _cast(par, torch.float32)
    err16, scale16 = _pred_err(sbv_predict_cuda(*par16, *b16, nu=nu),
                               sbv_predict_plain(*par16, *b16, nu=nu))
    assert err16 <= BF16_PRED_TOL * scale16


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("case", MULTI_CASES, ids=lambda c: "-".join(map(str, c)))
def test_multi_stats_tiled_kernel_edges(dev, case, nu):
    arrs, beta = _multi_case(case, dev)
    p0 = _multi_params(beta, 3, dev).structure_params()
    par = (p0.beta, p0.sigma2, p0.nugget)
    want = sbv_multi_stats_plain(*par, *arrs, nu=nu)
    got = sbv_multi_stats_cuda(*par, *arrs, nu=nu)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
    if case[0] == "holes":  # no real block point: [0, 0, .., 0]
        assert bool((got[1] == 0).all())
    got32 = sbv_multi_stats_cuda(*_cast(par, torch.float32), *_cast(arrs, torch.float32), nu=nu)
    torch.testing.assert_close(got32.double().sum(0), want.sum(0), rtol=5e-4, atol=0)
    b16 = _bf16(arrs, dev)
    par16 = _cast(par, torch.float32)
    want16 = sbv_multi_stats_plain(*par16, *b16, nu=nu)
    got16 = sbv_multi_stats_cuda(*par16, *b16, nu=nu)
    assert float(((got16 - want16).abs() / want16.abs().clamp(min=1)).max()) <= BF16_TOL


def _variant_operands(par, arrs, variant, dev, predict: bool):
    if variant == "f32":
        return _cast(par, torch.float32), _cast(arrs, torch.float32)
    if variant == "bf16":
        if predict:
            q_x, q_m, nn_x, nn_y, nn_m = arrs
            return _cast(par, torch.float32), (q_x.bfloat16(), q_m, nn_x.bfloat16(),
                                               nn_y.float(), nn_m)
        return _cast(par, torch.float32), _bf16(arrs, dev)
    return par, arrs


@pytest.mark.parametrize("variant", ["f64", "f32", "bf16"])
def test_multi_stats_panel_baseline_agrees_with_tiled(dev, variant):
    """The earlier design (padded blocks, 16-column right-looking panels),
    callable for the side-by-side timing, computes the same stats; its
    launches are not path launches."""
    arrs, beta = _multi_case(("holes", 37, 29, 20), dev)
    p0 = _multi_params(beta, 3, dev).structure_params()
    par, arrs = _variant_operands((p0.beta, p0.sigma2, p0.nugget), arrs, variant, dev, False)
    before = dict(_build.LAUNCHES)
    base = multi_launch("sbv_multi_stats_panel", *par, *arrs, nu=3.5)
    assert _build.LAUNCHES == before
    got = sbv_multi_stats_cuda(*par, *arrs)
    rel = float(((got.double() - base.double()).abs() / base.double().abs().clamp(min=1)).max())
    # f32: two f32 eliminations in different orders, per block within
    # chip_smoke.py's f32 limit (LADDER_TOL_F32, 3e-3 of max(1, |value|)).
    assert rel <= {"f64": 1e-10, "f32": 3e-3, "bf16": BF16_TOL}[variant]


@pytest.mark.parametrize("variant", ["f64", "f32", "bf16"])
def test_predict_panel_baseline_agrees_with_tiled(dev, variant):
    """As for the stats: the earlier predict design agrees with the tiled
    kernel, masked queries and empty blocks included."""
    arrs, beta = _predict_case(("holes", 25, 70, 20), dev)
    p = _params(beta, dev)
    par, arrs = _variant_operands((p.beta, p.sigma2, p.nugget), arrs, variant, dev, True)
    before = dict(_build.LAUNCHES)
    base = predict_panel(*par, *arrs, nu=3.5)
    assert _build.LAUNCHES == before
    err, scale = _pred_err(sbv_predict_cuda(*par, *arrs), base)
    assert err <= {"f64": 1e-10, "f32": 3e-3, "bf16": BF16_PRED_TOL}[variant] * scale


@pytest.mark.parametrize("variant", ["f64", "bf16"])
def test_predict_work_list_launch_equals_per_bucket_launches(dev, variant):
    """One launch over a chunk's buckets gives, bitwise, what one launch per
    bucket gives (each block runs the same instructions), and counts one."""
    from repro_torch.core.buckets import bucket_prediction

    x, y, beta = _data(seed=17)
    xt = np.random.default_rng(18).uniform(size=(300, 4))
    index = tpredict.build_train_index(x, y, beta, m_pred=40)
    packed = tpredict.pack_queries(index, xt, bs_pred=7, m_pred=40)
    pieces = [tuple(torch.as_tensor(a).to(dev) for a in pc.arrays())
              for pc in bucket_prediction(packed, n_buckets=3).buckets]
    assert len({(pc[0].shape[1], pc[2].shape[1]) for pc in pieces}) > 1
    p = _params(beta, dev)
    par, pieces = (p.beta, p.sigma2, p.nugget), pieces
    if variant == "bf16":
        par = _cast(par, torch.float32)
        pieces = [(q_x.bfloat16(), q_m, nn_x.bfloat16(), nn_y.float(), nn_m)
                  for q_x, q_m, nn_x, nn_y, nn_m in pieces]
    key = "sbv_predict_bf16" if variant == "bf16" else "sbv_predict"
    before = _build.LAUNCHES[key]
    many = sbv_predict_cuda_many(*par, pieces)
    assert _build.LAUNCHES[key] == before + 1
    each = [sbv_predict_cuda(*par, *pc) for pc in pieces]
    for (mu_a, var_a), (mu_b, var_b) in zip(many, each):
        assert torch.equal(mu_a, mu_b) and torch.equal(var_a, var_b)


def test_bucketed_predict_one_launch_per_chunk_bitwise(dev, monkeypatch):
    """predict_sbv with n_buckets launches the kernel once per chunk; its
    mean, variance and simulated outputs are bitwise those of one launch
    per bucket, drawn from the same per-bucket generators."""
    x, y, beta = _data(n=600, seed=19)
    xt = np.random.default_rng(20).uniform(size=(90, 4))
    p = _params(beta, dev)
    kw = dict(bs_pred=5, m_pred=24, n_sims=50, n_buckets=3, chunk_size=40)
    ops.reset_launch_counts()
    one = tpredict.predict_sbv(p, x, y, xt, **kw)
    assert ops.launch_counts()["sbv_predict"] == 3  # 90 points in chunks of 40

    def per_bucket(params, pieces, nu=3.5):
        acc = pieces[0][3].dtype
        par = (params.beta.to(acc), params.sigma2.to(acc), params.nugget.to(acc))
        return [sbv_predict_cuda(*par, *pc, nu=nu) for pc in pieces]

    monkeypatch.setattr(ops, "sbv_predict_many", per_bucket)
    ops.reset_launch_counts()
    many = tpredict.predict_sbv(p, x, y, xt, **kw)
    assert ops.launch_counts()["sbv_predict"] > 3
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        assert np.array_equal(getattr(one, f), getattr(many, f)), f


def test_kernels_refuse_wrong_dtype_mix(dev):
    """bf16 coordinates run only with f32 observations; f32 coordinates
    only with f32 ones; no operand is converted to another width."""
    packed, beta, _ = _bf16_case(3, False)
    arrs = vecchia.packed_arrays(packed, dev)
    par64 = tuple(torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (beta, 1.3, 1e-2))
    bx, by, bm, nx, ny, nm = arrs
    before = dict(_build.LAUNCHES)
    for coords, obs in ((torch.bfloat16, torch.float64), (torch.float32, torch.float64),
                        (torch.float64, torch.float32), (torch.float16, torch.float32)):
        with pytest.raises(TypeError):
            sbv_loglik_cuda(*par64, bx.to(coords), by.to(obs), bm, nx.to(coords), ny.to(obs), nm)
    with pytest.raises(TypeError):  # the two coordinate sets disagree
        sbv_loglik_cuda(*par64, bx.bfloat16(), by.float(), bm, nx.float(), ny.float(), nm)
    with pytest.raises(TypeError):
        sbv_multi_stats_cuda(*par64, bx.bfloat16(), by[..., None].double(), bm, nx.bfloat16(),
                             ny[..., None].double(), nm)
    with pytest.raises(TypeError):
        sbv_predict_cuda(*par64, bx.bfloat16(), bm, nx.bfloat16(), ny.double(), nm)
    with pytest.raises(TypeError):
        matern_cov_cuda(bx.bfloat16(), nx.float(), par64[0], par64[1])
    assert _build.LAUNCHES == before


def test_bucketed_bf16_fit_and_predict_launch_the_variants(dev):
    """fit_sbv / predict_sbv with n_buckets and the bf16 tier run the bf16
    variants on the card (the probe kept at bf16 with a loose budget) and
    agree with the CPU run of the same path to the f32 class."""
    from repro_torch.core.buckets import PrecisionPolicy
    from repro_torch.core.fit import fit_sbv

    x, y, beta = _data(n=600, seed=11)
    cfg = SBVConfig(n_blocks=20, m=16)
    init = KernelParams.create(sigma2=1.0, beta=0.5, nugget=1e-2, d=4)
    pol = PrecisionPolicy("bf16", error_budget=1.0)
    ops.reset_launch_counts()
    on_gpu = fit_sbv(x, y, cfg, init=init, inner_steps=3, outer_rounds=1, n_buckets=3,
                     precision=pol)
    counts = ops.launch_counts()
    n_b = len(on_gpu.precision_tiers)
    assert on_gpu.precision_tiers == ["bf16"] * n_b
    # Per bucket: the f64 and bf16 probes, then one bf16 launch per step.
    assert counts["sbv_loglik_bf16"] == n_b * (1 + 3) and counts["sbv_loglik"] == n_b
    on_cpu = fit_sbv(x, y, cfg, init=init, inner_steps=3, outer_rounds=1, n_buckets=3,
                     precision=pol, device="cpu")
    np.testing.assert_allclose([h[2] for h in on_gpu.history],
                               [h[2] for h in on_cpu.history], rtol=1e-4)
    xt = np.random.default_rng(12).uniform(size=(90, 4))
    kw = dict(bs_pred=5, m_pred=24, n_sims=50, n_buckets=3, precision="bf16")
    ops.reset_launch_counts()
    a = tpredict.predict_sbv(on_cpu.params, x, y, xt, **kw)
    assert ops.launch_counts()["sbv_predict_bf16"] >= 1
    assert ops.launch_counts()["sbv_predict"] == 0
    b = tpredict.predict_sbv(on_cpu.params, x, y, xt, device="cpu", **kw)
    np.testing.assert_allclose(a.mean, b.mean, rtol=0, atol=BF16_PRED_TOL)
    np.testing.assert_allclose(a.var, b.var, rtol=0, atol=BF16_PRED_TOL)


# -- the tiled covariance kernel and the exact-GP path -----------------------
#
# The tiled kernel against its plain version and against the earlier
# (row-wise) design, at shapes that reach each store path: odd nb in f64 and
# nb not a multiple of 4 in f32 (row pitch not a multiple of 16 bytes: the
# scalar stores), ragged tiles in both directions, na = 1, nb = 1, d = 1
# (with a bf16 point set of an odd element count: its last staged word is
# half outside the tensor) and d = 16. f64 is held at rel 1e-12 (the
# existing covariance limit; the two designs differ by an ulp or two in the
# sqrt, exp and the Matern's division by 3 and 15). f32 and bf16 are held,
# with the earlier design, against the exact function of the same inputs
# beside the plain f32 version (`chip_smoke.f32_cov_check`): 1e-5 wherever
# the plain version meets it; at d = 1 a few pairs lie ~1e-3 apart, where
# f32 rounding moves nu = 0.5 by ~1e-4 in both.
COV_SHAPES = [(2, 37, 61, 10), (1, 70, 130, 3), (3, 1, 129, 2), (2, 65, 1, 4), (1, 37, 61, 1),
              (1, 150, 257, 16), (2, 130, 256, 10)]


def _cov_case(shape, dtype, dev, seed=30):
    b, na, nb, d = shape
    rng = np.random.default_rng(seed)
    xa = torch.as_tensor(rng.uniform(size=(b, na, d)), device=dev)
    xb = torch.as_tensor(rng.uniform(size=(b, nb, d)), device=dev)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    beta = torch.linspace(0.31, 1.43, d, dtype=work, device=dev)
    return xa.to(dtype), xb.to(dtype), beta, torch.tensor(0.7, dtype=work, device=dev)


def _assert_cov(got, xa, xb, beta, s2, nu):
    """f64: rel 1e-12 against the plain version. f32 coordinates and bf16
    ones: `f32_cov_check` against the exact function of the same inputs
    (bf16: of the same rounded scaled coordinates, everything after in f64)
    beside the plain f32 (bf16-assembly) version."""
    if xa.dtype == torch.float64:
        torch.testing.assert_close(got, matern_cov_plain(xa, xb, beta, s2, nu=nu),
                                   rtol=1e-12, atol=1e-15)
        return
    assert got.dtype == torch.float32
    if xa.dtype == torch.float32:
        exact = matern_cov_plain(xa.double(), xb.double(), beta.double(), s2.double(), nu=nu)
    else:
        ones = torch.ones(beta.shape, dtype=torch.float64, device=beta.device)
        exact = matern_cov_plain(vecchia.narrow_scaled(xa, beta).double(),
                                 vecchia.narrow_scaled(xb, beta).double(), ones, s2.double(),
                                 nu=nu)
    c = f32_cov_check(got, matern_cov_plain(xa, xb, beta, s2, nu=nu), exact)
    assert c["ok"], c


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
@pytest.mark.parametrize("shape", COV_SHAPES)
def test_matern_cov_tiled_kernel_edges(dev, shape, nu, dtype):
    xa, xb, beta, s2 = _cov_case(shape, dtype, dev)
    key = "matern_cov_bf16" if dtype == torch.bfloat16 else "matern_cov"
    before = _build.LAUNCHES[key]
    got = matern_cov_cuda(xa, xb, beta, s2, nu=nu)
    rowwise = cov_launch("matern_cov_rowwise", xa, xb, beta, s2, nu)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 1
    assert got.shape == shape[:2] + (shape[2],)
    for k in (got, rowwise):
        _assert_cov(k, xa, xb, beta, s2, nu)
    if dtype == torch.float64:
        torch.testing.assert_close(got, rowwise, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [33, 100, 300])
def test_matern_cov_tiled_kernel_stages_any_d(dev, d, dtype):
    """The coordinates are staged 32 at a time: d = 33 (a second chunk of
    one coordinate; in bf16 every other point starts mid-word), 100 and 300
    (past the shared memory of the earlier design in f64), against the plain
    version, and a point's distance to itself still exactly 0 across
    chunks."""
    xa, xb, beta, s2 = _cov_case((2, 70, 131, d), dtype, dev)
    _assert_cov(matern_cov_cuda(xa, xb, beta, s2, nu=1.5), xa, xb, beta, s2, 1.5)
    diag = torch.diagonal(matern_cov_cuda(xa, xa, beta, s2, nu=0.5), dim1=-2, dim2=-1)
    assert bool((diag == s2 * torch.exp(-torch.sqrt(torch.tensor(1e-30, dtype=s2.dtype,
                                                                 device=dev)))).all())


def test_matern_cov_tiled_kernel_walks_more_than_65535_batches(dev):
    """The persistent grid walks every (b, tile) pair: B above the launch
    grid's y/z limit, one tile per batch entry."""
    xa, xb, beta, s2 = _cov_case((70_000, 3, 5, 2), torch.float64, dev)
    got = matern_cov_cuda(xa, xb, beta, s2)
    torch.testing.assert_close(got, matern_cov_plain(xa, xb, beta, s2), rtol=1e-12, atol=1e-15)
    xa32, xb32 = xa.float(), xb.float()
    torch.testing.assert_close(matern_cov_cuda(xa32, xb32, beta.float(), s2.float()).double(),
                               matern_cov_plain(xa, xb, beta, s2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_matern_cov_self_distance_is_exact(dev, dtype):
    """A point set against itself at nu = 0.5, whose exp(-r) is steepest at
    r = 0: every diagonal entry is bitwise sigma2 * exp(-sqrt(1e-30)), the
    value at a distance of exactly 0 (sigma2 itself in f32; in f64 the floor
    moves it by 1e-15 relative). A distance left at a rounding residue of
    eps * |z|^2 would move it by ~1e-8."""
    xa, _, beta, s2 = _cov_case((2, 300, 1, 10), dtype, dev)
    got = matern_cov_cuda(xa, xa, beta, s2, nu=0.5)
    floor = torch.tensor(1e-30, dtype=s2.dtype, device=dev)
    want = s2 * torch.exp(-torch.sqrt(floor))
    diag = torch.diagonal(got, dim1=-2, dim2=-1)
    assert bool((diag == want).all()), (diag.min().item(), diag.max().item(), want.item())
    if dtype != torch.float64:
        assert bool((diag == s2).all())


def test_kl_divergence_kernel_route_matches_plain_route(dev):
    """Eq. 4 at n = 2000 (d = 10, the paper's beta, nugget 1e-3) through the
    kernels and through the plain route. The two assemble K (and each
    block's matrices, principal submatrices of K or Schur complements of
    them, no worse conditioned) with different roundings, which the
    log-determinants amplify by at most cond(K): held at 10 eps cond(K) of
    the two halves' size."""
    rng = np.random.default_rng(31)
    n, d = 2000, 10
    x = rng.uniform(size=(n, d))
    beta = np.full(d, 5.0)
    beta[:2] = 0.05
    p = KernelParams.create(sigma2=1.0, beta=beta, nugget=1e-3, device=dev)
    packed, _ = preprocess(x, np.zeros(n), beta, SBVConfig(n_blocks=n // 10, m=30))
    ops.reset_launch_counts()
    kl = tkl.kl_divergence(p, x, packed)
    assert ops.launch_counts()["matern_cov"] == 1 and ops.launch_counts()["sbv_loglik"] == 1
    kl_ref = tkl.kl_divergence(p, x, packed, backend="ref")
    assert ops.launch_counts()["matern_cov"] == 1 and ops.launch_counts()["sbv_loglik"] == 1
    xt = torch.as_tensor(x, device=dev)
    cond = cond_bound(ops.matern_cov(xt[None], xt[None], p)[0], 1e-3)
    l0 = float(texact.exact_loglik(p, x, np.zeros(n), backend="ref"))
    tol = 10 * torch.finfo(torch.float64).eps * cond * (2 * abs(l0) + abs(kl_ref))
    assert kl >= 0 and abs(kl - kl_ref) <= tol, (kl, kl_ref, tol)


def test_exact_functions_run_on_cuda_and_match_cpu(dev):
    """The exact functions through the covariance kernel on the card against
    the CPU's plain route, at 10 eps cond(K) of each value's size."""
    rng = np.random.default_rng(32)
    x, y, xt = rng.uniform(size=(300, 4)), rng.normal(size=300), rng.uniform(size=(40, 4))
    p = KernelParams.create(sigma2=1.3, beta=np.linspace(0.3, 1.5, 4), nugget=1e-2)
    xx = torch.as_tensor(x)
    cond = cond_bound(matern_cov_plain(xx[None], xx[None], p.beta, p.sigma2)[0], 1e-2)
    tol = 10 * torch.finfo(torch.float64).eps * cond
    ops.reset_launch_counts()
    gpu = (texact.exact_loglik(p.to(dev), x, y), texact.exact_logdet(p.to(dev), x),
           *texact.exact_predict(p.to(dev), x, y, xt))
    assert ops.launch_counts()["matern_cov"] == 4
    cpu = (texact.exact_loglik(p, x, y, device="cpu"), texact.exact_logdet(p, x, device="cpu"),
           *texact.exact_predict(p, x, y, xt, device="cpu"))
    for g, c in zip(gpu, cpu):
        assert g.is_cuda
        scale = max(1.0, float(c.abs().max()))
        torch.testing.assert_close(g.cpu(), c, rtol=tol, atol=tol * scale)


# -- the streaming (out-of-core) fit on the card ------------------------------


def _stream_fit(dev, **kw):
    from repro_torch.core.fit import fit_sbv

    x, y, _ = _data(n=1500, d=4, seed=41)
    return fit_sbv(x, y, SBVConfig(n_blocks=24, m=20, seed=0), inner_steps=3, outer_rounds=2,
                   stream_chunk=300, device=dev, **kw)


def _fits_equal(a, b):
    return ([h[2] for h in a.history] == [h[2] for h in b.history]
            and all(torch.equal(u, v) for u, v in zip(a.params, b.params)))


def test_streaming_device_tier_matches_disk_tier_bitwise(dev):
    """Pieces resident on the card all round against pieces staged from disk
    through pinned memory and the spool's copy stream every step: the same
    fit, bit for bit; each step launches the kernel once per piece."""
    ops.reset_launch_counts()
    on_dev = _stream_fit(dev, device_cache=1 << 30, prefetch=0)
    s = on_dev.stream_stats
    assert s["n_pieces"] > 3 and s["device_cached_pieces"] == s["n_pieces"]
    assert ops.launch_counts()["sbv_loglik"] == 2 * 3 * s["n_pieces"]
    disk = _stream_fit(dev, device_cache=0, prefetch=0)
    assert disk.stream_stats["h2d_bytes_per_step"] == disk.stream_stats["spool_bytes"]
    assert on_dev.params.log_beta.is_cuda and _fits_equal(on_dev, disk)


def test_streaming_prefetch_matches_synchronous_bitwise(dev):
    """The copy thread stages disk pieces two ahead on its own stream; the
    consumer waits on each copy's event. Against the synchronous loop, and
    a mixed-tier spool against both."""
    sync = _stream_fit(dev, device_cache=0, prefetch=0)
    pre = _stream_fit(dev, device_cache=0, prefetch=2)
    half = _stream_fit(dev, device_cache=sync.stream_stats["spool_bytes"] // 2, prefetch=2)
    assert 0 < half.stream_stats["device_cached_pieces"] < half.stream_stats["n_pieces"]
    assert _fits_equal(pre, sync) and _fits_equal(half, sync)


def test_device_cache_budget_within_free_memory(dev):
    from repro_torch.data.streaming import device_cache_budget

    free, total = torch.cuda.mem_get_info(dev)
    budget = device_cache_budget(device=dev)
    reserved = device_cache_budget(frac=0.5, reserve_bytes=1 << 30, device=dev)
    free_after = torch.cuda.mem_get_info(dev)[0]
    assert 0 < budget <= max(free, free_after) <= total
    assert reserved <= max(0, max(free, free_after) // 2 - (1 << 30))
    assert device_cache_budget(reserve_bytes=2 * total, device=dev) == 0
    auto = _stream_fit(dev).stream_stats
    assert auto["device_cached_pieces"] == auto["n_pieces"]
    assert 0 < auto["device_cache_budget"] <= free


def test_bf16_piece_spool_round_trip_on_cuda(dev, tmp_path):
    """A bf16-cast piece spooled to disk (uint16 under ``__bf16__``) and
    staged back to the card through pinned memory: every array bitwise."""
    from repro_torch.core.buckets import cast_packed
    from repro_torch.data.streaming import PackedChunkSpool

    x, y, beta = _data(n=600, d=4, seed=42)
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=12, m=20))
    piece = cast_packed(packed, "bf16")
    keys = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask")
    for budget in (0, 1 << 30):
        sp = PackedChunkSpool(str(tmp_path / f"sp{budget}"), device_budget=budget, device=dev)
        sp.add(piece)
        sp.add(piece)
        for prefetch in (0, 2):
            for arrs, _ in sp.iter_arrays(prefetch=prefetch):
                for a, k in zip(arrs, keys):
                    want = torch.as_tensor(getattr(piece, k))
                    assert a.is_cuda and a.dtype == want.dtype and torch.equal(a.cpu(), want), k
        sp.cleanup()


# -- distributed (Alg. 1) and multi-host (Alg. 2) on the card -----------------


def _mesh_problem(dev, k=4):
    from repro_torch.launch.mesh import make_worker_mesh

    x, y, beta = _data(n=1200)
    packed, _ = preprocess(x, y, beta, SBVConfig(n_blocks=30, m=30, n_workers=k))
    return packed, _params(beta, dev), make_worker_mesh(k)


def test_distributed_shards_match_one_shard_on_card(dev):
    """4 workers on the card against the serial loss closure: one kernel
    launch per shard, loss within 1e-12, gradient within 1e-11. A
    gradient leaf sums per-block terms of both signs, so the shard order
    moves it by more than the loss: one leaf (-1.17) moved by 1.0e-12 of
    its size in the first run on an H100."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.fit import _value_and_grad, neg_loglik_fn

    packed, p, mesh = _mesh_problem(dev)
    assert all(d.type == "cuda" for d in mesh.devices)
    v1, g1 = _value_and_grad(neg_loglik_fn(packed, 3.5, "auto", device=dev), p)
    before = _build.LAUNCHES["sbv_loglik"]
    v4, g4 = _value_and_grad(dist.distributed_neg_loglik_fn(packed, 3.5, mesh), p)
    assert _build.LAUNCHES["sbv_loglik"] - before == 4
    np.testing.assert_allclose(float(v4), float(v1), rtol=1e-12)
    for a, b in zip(g4, g1):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-11)


def test_distributed_bucketed_evaluation_on_card(dev):
    from repro_torch.core import buckets
    from repro_torch.core import distributed as dist

    packed, p, mesh = _mesh_problem(dev)
    bk = buckets.bucket_blocks(packed, n_buckets=3)
    want = vecchia.bucketed_loglik(p, bk)
    before = _build.LAUNCHES["sbv_loglik"]
    got = dist.distributed_bucketed_loglik(p, bk, mesh)
    assert _build.LAUNCHES["sbv_loglik"] - before == 4 * bk.n_buckets
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_sharded_predict_on_card_is_bitwise(dev):
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_worker_mesh

    x, y, beta = _data(n=1200)
    index = tpredict.build_train_index(x, y, beta, 40, n_workers=4)
    xq = np.random.default_rng(3).uniform(size=(300, 4))
    packed = tpredict.pack_queries(index, xq, bs_pred=8, m_pred=40, n_workers=4)
    p = _params(beta, dev)
    mu, var = tpredict.batched_block_predict(p, *(torch.as_tensor(a).to(dev)
                                                  for a in packed.arrays()))
    before = _build.LAUNCHES["sbv_predict"]
    sharded, mu4, var4 = dist.sharded_packed_predict(p, packed, make_worker_mesh(4))
    assert _build.LAUNCHES["sbv_predict"] - before == 4
    got, want = (np.zeros((2, 300)) for _ in range(2))
    tpredict.scatter_packed(packed, (mu, want[0]), (var, want[1]))
    tpredict.scatter_packed(sharded, (mu4, got[0]), (var4, got[1]))
    np.testing.assert_array_equal(got, want)


def test_two_rank_gloo_fit_on_card(dev, tmp_path):
    """``fit_gp --distributed-hosts 2 --device cuda`` at the CPU tests'
    fixture: 2 ranks share the card, spread 0.0, within 1e-8 of the serial
    streaming fit on the card, each rank launching the kernel."""
    import json
    import os
    import subprocess

    from repro_torch.core.fit import fit_sbv
    from repro_torch.data.store import ArrayStore

    rng = np.random.default_rng(0)
    x, y = rng.uniform(size=(2000, 4)), rng.normal(size=2000)
    store = ArrayStore.from_arrays(str(tmp_path / "s"), x, y, shard_rows=512)
    kw = dict(blocks=24, m=8, inner_steps=4, outer_rounds=2, stream_chunk=600)
    serial = fit_sbv(store, None, SBVConfig(n_blocks=24, m=8, seed=0), inner_steps=4,
                     outer_rounds=2, stream_chunk=600, device=dev)
    result = str(tmp_path / "r.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.fit_gp", "--store", store.path,
           "--distributed-hosts", "2", "--seed", "0", "--device", "cuda", "--timeout", "240",
           "--result-json", result]
    for k, v in kw.items():
        cmd += [f"--{k.replace('_', '-')}", str(v)]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(cmd, cwd=str(root), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(result) as f:
        merged = json.load(f)
    assert merged["max_nll_spread"] == 0.0
    assert abs(merged["nll"] - serial.history[-1][2]) <= 1e-8
    assert all(rk["launches"]["sbv_loglik"] > 0 for rk in merged["ranks"])


# -- serving and tuning (ROADMAP items 11 and 12) ----------------------------


def _serving_problem(dev, n=1500, d=4):
    from repro_torch.serving import PipelineConfig

    x, y, beta = _data(n=n, d=d)
    p = _params(beta, dev)
    cfg = PipelineConfig(bs_pred=8, m_pred=40, chunk_size=256, n_buckets=None)
    index = tpredict.build_train_index(x, y, beta, cfg.m_pred, seed=0)
    return x, y, p, cfg, index


def test_pipelined_stream_is_bitwise_synchronous_on_card(dev):
    """The double-buffered engine (pinned uploads on a side stream, events,
    one predict launch per chunk) gives the synchronous loop's bits, uniform
    and bucketed, and launches once per chunk."""
    from repro_torch.serving import ChunkTimer, PipelineConfig, predict_pipelined, \
        predict_synchronous

    x, y, p, cfg, index = _serving_problem(dev)
    xq = np.random.default_rng(4).uniform(size=(1100, 4))
    for c in (cfg, PipelineConfig(bs_pred=8, m_pred=40, chunk_size=256, n_buckets=3)):
        before = _build.LAUNCHES["sbv_predict"]
        ms, vs = predict_synchronous(p, index, xq, c, seed=2, device=dev)
        assert _build.LAUNCHES["sbv_predict"] - before == 5
        timer = ChunkTimer()
        mp, vp = predict_pipelined(p, index, xq, c, seed=2, device=dev, timer=timer)
        np.testing.assert_array_equal(mp, ms)
        np.testing.assert_array_equal(vp, vs)
        s = timer.summary()
        assert s["n_chunks"] == 5 and s["compute_s"] > 0


def test_served_request_equals_predict_sbv_on_card(dev):
    """A request served by a continuous-mode ``GPServer`` on the card (its
    own stream) equals the lone ``predict_sbv`` on the card at 1e-12, and
    so does one routed through two replicas."""
    from repro_torch.serving import (BatchingPolicy, GPServer, GPServerConfig,
                                     ReplicaRouter, SchedulerPolicy)

    x, y, p, cfg, _ = _serving_problem(dev)
    conf = GPServerConfig(pipeline=cfg, policy=BatchingPolicy(max_wait_s=0.002),
                          scheduler=SchedulerPolicy(), seed=3)
    reps = [GPServer(p, x, y, conf, device=dev)]
    reps.append(GPServer(p, x, y, conf, index=reps[0].index, device=dev))
    assert reps[0]._stream is not None and reps[0]._stream != reps[1]._stream
    rng = np.random.default_rng(8)
    xs = [rng.uniform(size=(n, 4)) for n in (700, 33, 1, 300)]
    with ReplicaRouter(reps, routing="round_robin") as router:
        futs = [router.submit(xq) for xq in xs]
        router.flush()
        results = [f.result(timeout=300) for f in futs]
    for xq, res in zip(xs, results):
        want = tpredict.predict_sbv(p, x, y, xq, bs_pred=8, m_pred=40, seed=3, chunk_size=256,
                                    n_sims=2, device=dev)
        np.testing.assert_allclose(res.mean, want.mean, rtol=0, atol=1e-12)
        np.testing.assert_allclose(res.var, want.var, rtol=0, atol=1e-12)


def test_staged_upload_is_pinned_and_leaves_the_default_stream_free(dev, monkeypatch):
    """``upload`` copies through pinned memory without waiting for the
    stream: with the default stream held by a spinning kernel, the upload
    call and the predict launch (its descriptor list included) return at
    once; a staging on a side stream completes while the default stream
    is still busy."""
    import time

    from repro_torch.serving.pipeline import PipelineConfig, _stage, make_chunk_split

    pinned = []
    real_pin = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self, *a, **k: pinned.append(self.shape) or real_pin(self))
    x, y, p, cfg, index = _serving_problem(dev)
    packed = tpredict.pack_queries(index, np.random.default_rng(1).uniform(size=(256, 4)), 8,
                                   40, pad_shapes=True)
    warm = [torch.as_tensor(a).to(dev) for a in packed.arrays()]
    ops.sbv_predict_many(p, [tuple(warm)])  # loads the library
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))          # ~1 s of spinning on the default stream
    t0 = time.perf_counter()
    arrs = [tpredict.upload(a, dev) for a in packed.arrays()]
    params = tpredict.place_params(p, dev)
    (mu, var), = ops.sbv_predict_many(params, [tuple(arrs)])
    host_s = time.perf_counter() - t0
    assert not torch.cuda.current_stream(dev).query()  # still spinning
    assert host_s < 0.3, host_s
    assert len(pinned) >= len(arrs)
    side = torch.cuda.Stream(dev)
    torch.cuda._sleep(int(2e9))
    _, _, staged, event, _ = _stage(make_chunk_split(PipelineConfig(bs_pred=8, m_pred=40)),
                                    dev, side)((0, lambda: packed))
    event.synchronize()                  # the side stream finished its copies ...
    assert not torch.cuda.current_stream(dev).query()  # ... the default one has not
    torch.cuda.synchronize()
    for got, want in zip(staged[0], packed.arrays()):
        np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
    want = tpredict.block_predict(p.beta, p.sigma2, p.nugget, *(torch.as_tensor(a).to(dev)
                                                                for a in packed.arrays()))
    msk = torch.as_tensor(packed.q_mask).to(dev)
    assert float((mu - want[0]).abs()[msk].max()) <= 1e-10


def test_autotune_on_card_launches_the_likelihood_kernel(dev, tmp_path):
    """``autotune_loglik`` times every candidate through ``sbv_loglik`` on
    the card (f64 and bf16 variants) and saves a record that drives
    ``fit_sbv(tuning=)``."""
    from repro_torch.core.fit import fit_sbv
    from repro_torch.tuning import TuningRecord, autotune_loglik

    x, y, _ = _data(n=3000)
    cfg = SBVConfig(n_blocks=40, m=20)
    before = dict(_build.LAUNCHES)
    rec = autotune_loglik(x, y, cfg, bucket_grid=(0, 2), tiers=("bf16", "f64"), repeats=2,
                          save_dir=str(tmp_path), device=dev)
    assert _build.LAUNCHES["sbv_loglik"] > before["sbv_loglik"]
    assert rec.meta["device"] == "cuda" and len(rec.candidates) == 4
    assert all(c["time_s"] > 0 for c in rec.candidates)
    assert TuningRecord.load(str(tmp_path)).to_dict() == rec.to_dict()
    res = fit_sbv(x, y, cfg, inner_steps=2, outer_rounds=1, tuning=str(tmp_path), device=dev)
    assert np.isfinite(res.history[-1][2])


# -- the flash-attention backward kernel and the training step ---------------

# (B, H, Hkv, S, T, hd, causal, window, softcap): every head_dim, GQA and
# MHA, S != T both ways, S and T off the 32-row tiles, windows that cross
# tiles, rows with no allowed key (causal and not), softcaps.
BWD_CASES = [
    (2, 4, 2, 256, 256, 128, True, 0, 0.0),     # the path's layout, GQA, causal
    (1, 2, 1, 300, 300, 128, True, 17, 0.0),    # window 17
    (1, 2, 2, 200, 200, 128, True, 0, 50.0),    # softcap 50
    (1, 2, 1, 520, 520, 128, True, 150, 30.0),  # window and softcap
    (1, 2, 2, 100, 37, 32, True, 0, 0.0),       # S > T, top-left aligned
    (1, 2, 2, 96, 16, 32, True, 8, 0.0),        # rows with no allowed key
    (1, 2, 2, 96, 16, 64, False, 8, 0.0),       # the same, not causal
    (1, 2, 1, 64, 200, 80, False, 0, 0.0),      # S < T, not causal, hd 80
    (2, 4, 2, 150, 150, 64, True, 0, 0.0),
    (1, 4, 4, 77, 77, 32, True, 0, 5.0),
    (1, 4, 2, 130, 130, 256, True, 0, 0.0),
    (1, 2, 1, 45, 45, 256, True, 20, 10.0),
    (1, 2, 1, 1, 1, 128, True, 0, 0.0),
]


def _check_bwd(dev, dtype, case):
    """The backward kernels (the route ``flash_bwd_route`` gives) against
    autograd through the plain version (``chip_smoke.grad_check``'s
    limits), one launch counted, and the same bits on a second call."""
    from chip_smoke import grad_check
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain)

    b, h, hkv, s, t, hd, causal, window, cap = case
    q, k, v = _flash_inputs(dev, dtype, b, h, hkv, s, t, hd)
    do = _flash_inputs(dev, dtype, b, h, h, s, 1, hd, seed=12)[0]
    before = _build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, do, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_plain(q, k, v, do, causal=causal, window=window, softcap=cap)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == dtype, name
        res = grad_check(g, w)
        assert res["ok"], (name, res)
    again = flash_attention_bwd_cuda(q, k, v, do, causal=causal, window=window, softcap=cap)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))  # no atomics: deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernel_matches_plain_autograd(dev, dtype, case):
    _check_bwd(dev, dtype, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["causal", "window", "softcap"])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
def test_flash_bwd_every_head_dim_and_mask(dev, dtype, mode, hd):
    """Every head_dim under each mask (GQA, S = T = 100: off the 32-row tiles)."""
    _check_bwd(dev, dtype, (1, 4, 2, 100, 100, hd, True, 23 if mode == "window" else 0,
                            7.0 if mode == "softcap" else 0.0))


def test_flash_bwd_takes_model_layout_strides(dev):
    """(B, S, H, hd) projections seen as (B, H, S, hd): the gradients come
    back in that layout and equal those of contiguous copies."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 100, 4, 64, generator=g, device=dev)
    kv = torch.randn(2, 100, 2, 64, generator=g, device=dev)
    do = torch.randn(2, 100, 4, 64, generator=g, device=dev)
    q, k, v, dot = x.transpose(1, 2), kv.transpose(1, 2), (2 * kv).transpose(1, 2), do.transpose(1, 2)
    got = flash_attention_bwd_cuda(q, k, v, dot)
    want = flash_attention_bwd_cuda(*(t.contiguous() for t in (q, k, v, dot)))
    assert got[0].stride() == q.stride()
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)


def test_flash_function_launches_both_kernels(dev):
    from chip_smoke import grad_check
    from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_bwd_plain

    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(dev, torch.bfloat16, 1, 4, 2, 200,
                                                             200, 128))
    do = torch.randn_like(q)
    ops.reset_launch_counts()
    o = FlashAttention.apply(q, k, v, True, 0, 0.0)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    want = flash_attention_bwd_plain(q, k, v, do)
    for g, w in zip(got, want):
        assert grad_check(g, w)["ok"]


# The backward's 'wgmma' route (bf16 at hd 64, 80, 128 and 256): GQA at n_rep 1,
# 2, 4 and 8, S off the 32-, 64- and 128-row tiles, S < T and S > T without
# causality, a window, a softcap, both (gemma2's softcap at a window that
# binds), rows with no allowed key (causal and not), a single row. (B, H,
# Hkv, S, T, causal, window, softcap.)
WGMMA_BWD_CASES = [
    (1, 4, 4, 200, 200, True, 0, 0.0),
    (2, 4, 2, 200, 200, True, 0, 0.0),
    (1, 8, 2, 333, 333, True, 0, 0.0),
    (1, 4, 2, 100, 300, False, 0, 0.0),
    (1, 4, 2, 300, 100, False, 0, 0.0),
    (1, 4, 2, 300, 300, True, 70, 0.0),
    (1, 4, 2, 257, 257, True, 0, 20.0),
    (1, 4, 2, 260, 40, True, 16, 0.0),
    (1, 4, 2, 260, 40, False, 16, 0.0),
    (1, 4, 2, 1, 1, True, 0, 0.0),
    (1, 4, 2, 1, 300, False, 0, 0.0),
    (1, 4, 2, 130, 130, True, 0, 0.0),
    (1, 8, 1, 300, 300, True, 0, 0.0),
    (2, 4, 2, 300, 300, True, 100, 50.0),
]


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("case", WGMMA_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_wgmma_route_matches_plain_autograd(dev, case, hd):
    from repro_torch.kernels.flash_attention import flash_bwd_route

    assert flash_bwd_route(torch.bfloat16, hd) == "wgmma"
    b, h, hkv, s, t, causal, window, cap = case
    _check_bwd(dev, torch.bfloat16, (b, h, hkv, s, t, hd, causal, window, cap))


@pytest.mark.parametrize("case", [(2, 4, 2, 300, 300, 128, True, 0, 0.0),
                                  (1, 4, 2, 200, 200, 64, True, 33, 0.0),
                                  (1, 2, 1, 150, 150, 128, True, 0, 10.0),
                                  (1, 4, 2, 260, 40, 128, True, 16, 0.0),
                                  (1, 2, 2, 100, 300, 64, False, 0, 0.0),
                                  (2, 4, 4, 300, 300, 80, True, 0, 0.0),
                                  (1, 4, 2, 260, 40, 80, True, 16, 0.0)],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_stats_from_the_forward_match_plain(dev, case):
    """The wgmma forward's row statistics against the plain version's: m
    exactly -1e30 where the row has no allowed key (and 1 / l = 1 / T
    there), m within 1e-5 and 1 / l within 1e-5 relative elsewhere; the
    output is the same bits with and without them. The backward gives the
    same gradients from the plain statistics (copied into the kernel's
    padded layout) as from the kernel's, within the bf16 limits."""
    from chip_smoke import grad_check
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    b, h, hkv, s, t, hd, causal, window, cap = case
    q, k, v = _flash_inputs(dev, torch.bfloat16, b, h, hkv, s, t, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, stats = flash_attention_cuda(q, k, v, return_stats=True, **kw)
    torch.cuda.synchronize()
    assert stats.shape == (2, b, h, s) and stats.dtype == torch.float32
    assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))
    _, want = flash_attention_plain(q, k, v, return_stats=True, **kw)
    empty = want[0] == -1e30
    assert bool((stats[0][empty] == -1e30).all())
    torch.testing.assert_close(stats[1][empty], torch.full_like(stats[1][empty], 1.0 / t),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(stats[0][~empty], want[0][~empty], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[1], want[1], rtol=1e-5, atol=0)
    do = _flash_inputs(dev, torch.bfloat16, b, h, h, s, 1, hd, seed=12)[0]
    from_kernel = flash_attention_bwd_cuda(q, k, v, do, stats=stats, **kw)
    from_plain = flash_attention_bwd_cuda(q, k, v, do, stats=want, **kw)
    for a, b_ in zip(from_plain, from_kernel):
        assert grad_check(a, b_)["ok"]


def test_flash_function_runs_the_wgmma_backward_once(dev, monkeypatch):
    """``FlashAttention`` on bf16 hd 128: one forward launch that keeps the
    statistics, one backward launch on the 'wgmma' route reading them."""
    from chip_smoke import grad_check
    from repro_torch.kernels import flash_attention as fa

    calls = []
    real = fa._bwd_launch

    def spy(route, *args):
        calls.append((route, args[-1] is not None))
        return real(route, *args)

    monkeypatch.setattr(fa, "_bwd_launch", spy)
    q, k, v = (x.requires_grad_(True) for x in _flash_inputs(dev, torch.bfloat16, 2, 8, 2, 300,
                                                             300, 128))
    do = torch.randn_like(q)
    ops.reset_launch_counts()
    o = fa.FlashAttention.apply(q, k, v, True, 0, 0.0)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    assert calls == [("wgmma", True)]
    for g, w in zip(got, fa.flash_attention_bwd_plain(q, k, v, do)):
        assert grad_check(g, w)["ok"]


def test_flash_bwd_scalar_baseline_stays_callable_at_hd128(dev):
    """The scalar kernels stay callable on bf16 hd 128 (``_bwd_launch
    ("scalar", ...)``, uncounted) for the smoke's side-by-side timing, and
    agree with the wgmma route within the bf16 limits."""
    from chip_smoke import grad_check
    from repro_torch.kernels.flash_attention import _bwd_launch, flash_attention_bwd_cuda

    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 4, 2, 300, 300, 128)
    do = torch.randn_like(q)
    before = dict(_build.LAUNCHES)
    base = _bwd_launch("scalar", q, k, v, do, True, 0, 0.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before
    for a, b_ in zip(flash_attention_bwd_cuda(q, k, v, do), base):
        assert grad_check(a, b_)["ok"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_train_step_on_card_matches_cpu(dev, dtype):
    """One step of the reduced internlm2 (GQA) on the card against the same
    step on the CPU from the same weights and batch: loss and grad norm at
    rtol 1e-4 in f32 (the kernels' and cuBLAS's f32 sums in other orders),
    2e-2 in bf16; the params at 10 lr. The flash forward launches twice per
    layer (the forward and the remat recompute), the backward once."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.training.train_step import make_train_step, train_state_init

    cfg = get_config("internlm2-1.8b").reduced(n_layers=2, vocab=128, n_kv_heads=2, dtype=dtype)
    cpu = train_state_init(init_params(cfg, torch.Generator().manual_seed(0)))
    card = type(cpu)(params=tuple(p.to(dev) for p in cpu.params),
                     opt=type(cpu.opt)(0, tuple(m.to(dev) for m in cpu.opt.mu),
                                       tuple(m.to(dev) for m in cpu.opt.nu)), step=0)
    rng = np.random.default_rng(1)
    tok, lab = (rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32) for _ in range(2))
    lr = 1e-3
    step = make_train_step(cfg, lr=lr)
    ops.reset_launch_counts()
    card, mc = step(card, tok, lab)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == cfg.n_layers
    cpu, mh = step(cpu, tok, lab)
    rtol = 1e-4 if dtype == "float32" else 2e-2
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[key]), float(mh[key]), rtol=rtol, err_msg=key)
    for a, b_ in zip(card.params, cpu.params):
        assert a.is_cuda and a.dtype == b_.dtype
        torch.testing.assert_close(a.cpu().float(), b_.float(), rtol=0, atol=10 * lr)


# -- gemma2 and the MoE stacks -------------------------------------------------
#
# gemma2's head_dim 256 reaches the forward's and the backward's 'wgmma'
# routes in bf16 (f32: 'scalar_f32' and 'scalar'), with its softcap of 50 and
# a window that binds (100 at S = 600; gemma2's own is 4096).

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_hd256_window_softcap_matches_plain(dev, dtype):
    case = (1, 4, 2, 600, 600, 256, True, 100, 50.0)
    b, h, hkv, s, t, hd, causal, window, cap = case
    assert flash_route(torch.bfloat16, hd) == "wgmma"
    q, k, v = _flash_inputs(dev, dtype, b, h, hkv, s, t, hd)
    queries = [q] if dtype == torch.float32 else [q, _edge_queries(k, h, s, window)]
    for qq in queries:
        want = flash_attention_plain(qq, k, v, causal=causal, window=window, softcap=cap)
        got = flash_attention_cuda(qq, k, v, causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
        if dtype == torch.bfloat16:
            assert _row_rel_err(got, want) <= FLASH_ROW_TOL
    from repro_torch.kernels.flash_attention import flash_bwd_route
    assert flash_bwd_route(torch.bfloat16, hd) == "wgmma"
    _check_bwd(dev, dtype, case)


# The forward's wgmma route at hd 256 (gemma2; its backward takes
# WGMMA_BWD_CASES): S and T off the 64- and 128-row tiles (130, 300), S < T
# and S > T without causality, GQA at n_rep 1, 2 and 8, a window of 100 with
# a softcap of 50, rows with no allowed key (causal and not), one row. (B,
# H, Hkv, S, T, causal, window, softcap.)
HD256_CASES = [
    (1, 4, 2, 130, 130, True, 0, 0.0),
    (1, 2, 2, 300, 300, True, 0, 0.0),
    (1, 8, 1, 300, 300, True, 0, 0.0),
    (1, 4, 2, 100, 300, False, 0, 0.0),
    (1, 4, 2, 300, 100, False, 0, 0.0),
    (2, 4, 2, 300, 300, True, 100, 50.0),
    (1, 4, 2, 300, 40, True, 8, 0.0),
    (1, 4, 2, 260, 40, False, 16, 0.0),
    (1, 4, 2, 1, 1, True, 0, 0.0),
]


@pytest.mark.parametrize("case", HD256_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_hd256_wgmma_forward_matches_plain(dev, case):
    """Both instantiations of the hd-256 wgmma forward (without and with
    the row statistics) against the plain version, on random and edge
    queries: the bf16 limits elementwise and per row, the same output bits
    with and without the statistics, and the statistics as the hd-128
    kernel's are held (m exactly -1e30 on rows with no allowed key), but
    1 / l within 3e-5 relative: the edge queries' scores reach ~50 in log2
    units at hd 256, and the f32 sums of 256 products in the tensor cores'
    order and in the plain version's differ by ~1e-5 of that, which moves
    l by as much (1.29e-5 read on an H100 at S = 100, T = 300)."""
    assert flash_route(torch.bfloat16, 256) == "wgmma"
    b, h, hkv, s, t, causal, window, cap = case
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v = _flash_inputs(dev, torch.bfloat16, b, h, hkv, s, t, 256)
    for qq in (q, _edge_queries(k, h, s, window)):
        want, want_st = flash_attention_plain(qq, k, v, return_stats=True, **kw)
        before = _build.LAUNCHES["flash_attention"]
        got = flash_attention_cuda(qq, k, v, **kw)
        got_st, st = flash_attention_cuda(qq, k, v, return_stats=True, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attention"] == before + 2
        assert torch.equal(got, got_st)
        torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
        assert _row_rel_err(got, want) <= FLASH_ROW_TOL
        empty = want_st[0] == -1e30
        assert bool((st[0][empty] == -1e30).all())
        torch.testing.assert_close(st[0][~empty], want_st[0][~empty], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st[1], want_st[1], rtol=3e-5, atol=0)


def test_flash_hd256_wgmma_takes_model_layout_strides(dev):
    """The hd-256 wgmma kernels read the model's (B, S, H, hd) projections
    through their tensor maps without a copy and write the model's layout,
    with the same bits as on contiguous copies."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    g = torch.Generator(device=dev).manual_seed(6)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(torch.bfloat16)
    x, kv, vv, do = mk(2, 300, 4, 256), mk(2, 300, 2, 256), mk(2, 300, 2, 256), mk(2, 300, 4, 256)
    q, k, v, dot = (a.transpose(1, 2) for a in (x, kv, vv, do))
    assert all(_kernel_ready(a) is a for a in (q, k, v, dot))
    kw = dict(causal=True, window=100, softcap=50.0)
    got = flash_attention_cuda(q, k, v, **kw)
    assert got.transpose(1, 2).is_contiguous()
    contiguous = [a.contiguous() for a in (q, k, v, dot)]
    assert torch.equal(got, flash_attention_cuda(*contiguous[:3], **kw))
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    assert _row_rel_err(got, want) <= FLASH_ROW_TOL
    grads = flash_attention_bwd_cuda(q, k, v, dot, **kw)
    assert grads[0].stride() == q.stride()
    for a, b_ in zip(grads, flash_attention_bwd_cuda(*contiguous, **kw)):
        assert torch.equal(a, b_)


def test_flash_hd256_scalar_baselines_stay_callable(dev):
    """The scalar kernels stay callable on bf16 hd 256 (``_launch`` of
    ``ROUTES['scalar_bf16']`` and ``_bwd_launch('scalar', ...)``, both
    uncounted) for the smoke's side-by-side timing: each holds against the
    plain version, and the wgmma routes agree with them within the bf16
    limits."""
    from chip_smoke import grad_check
    from repro_torch.kernels.flash_attention import (_bwd_launch, flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain)

    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 4, 2, 300, 300, 256)
    do = _flash_inputs(dev, torch.bfloat16, 1, 4, 4, 300, 1, 256, seed=12)[0]
    before = dict(_build.LAUNCHES)
    base = flash_launch(ROUTES["scalar_bf16"], q, k, v, True, 100, 50.0)
    base_g = _bwd_launch("scalar", q, k, v, do, True, 100, 50.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before
    kw = dict(causal=True, window=100, softcap=50.0)
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(base.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    got = flash_attention_cuda(q, k, v, **kw)
    assert _row_rel_err(got, base) <= FLASH_ROW_TOL
    want_g = flash_attention_bwd_plain(q, k, v, do, **kw)
    for a, b_, w in zip(flash_attention_bwd_cuda(q, k, v, do, **kw), base_g, want_g):
        assert grad_check(b_, w)["ok"] and grad_check(a, b_)["ok"]


# The forward's wgmma route at hd 80 (zamba2's shared block; its backward
# takes WGMMA_BWD_CASES): the second 64-column box of every tile holds
# columns 64-79 and TMA's zeros. S and T off the 128-row tiles, T < S and
# S < T without causality, H = Hkv (zamba2), GQA at n_rep 2 and 8, a window
# with a softcap, rows with no allowed key (causal and not), one row. (B, H,
# Hkv, S, T, causal, window, softcap.)
HD80_CASES = [
    (2, 4, 4, 300, 300, True, 0, 0.0),
    (1, 4, 2, 130, 130, True, 0, 0.0),
    (1, 8, 1, 257, 257, True, 0, 0.0),
    (1, 4, 2, 100, 300, False, 0, 0.0),
    (1, 4, 2, 300, 100, False, 0, 0.0),
    (2, 4, 2, 300, 300, True, 100, 50.0),
    (1, 4, 2, 300, 40, True, 8, 0.0),
    (1, 4, 2, 260, 40, False, 16, 0.0),
    (1, 4, 2, 1, 1, True, 0, 0.0),
]


@pytest.mark.parametrize("case", HD80_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_hd80_wgmma_forward_matches_plain(dev, case):
    """Both instantiations of the wgmma forward at hd 80 (without and with
    the row statistics) against the plain version, on random and edge
    queries: the bf16 limits elementwise and per row, the same output bits
    with and without the statistics, and the statistics as at hd 64 and 128
    (m exactly -1e30 on rows with no allowed key, 1 / l = 1 / T there; m
    within 1e-5, 1 / l within 1e-5 relative elsewhere)."""
    assert flash_route(torch.bfloat16, 80) == "wgmma"
    b, h, hkv, s, t, causal, window, cap = case
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v = _flash_inputs(dev, torch.bfloat16, b, h, hkv, s, t, 80)
    for qq in (q, _edge_queries(k, h, s, window)):
        want, want_st = flash_attention_plain(qq, k, v, return_stats=True, **kw)
        before = _build.LAUNCHES["flash_attention"]
        got = flash_attention_cuda(qq, k, v, **kw)
        got_st, st = flash_attention_cuda(qq, k, v, return_stats=True, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attention"] == before + 2
        assert got.shape == (b, h, s, 80) and torch.equal(got, got_st)
        torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
        assert _row_rel_err(got, want) <= FLASH_ROW_TOL
        empty = want_st[0] == -1e30
        assert bool((st[0][empty] == -1e30).all())
        torch.testing.assert_close(st[1][empty], torch.full_like(st[1][empty], 1.0 / t),
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(st[0][~empty], want_st[0][~empty], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st[1], want_st[1], rtol=1e-5, atol=0)


def test_flash_hd80_wgmma_takes_model_layout_strides(dev):
    """zamba2's layout: q, k, v and the cotangent are (B, S, H, 80) buffers
    seen as (B, H, S, 80), a 160-byte head stride, read through the tensor
    maps without a copy (the second box of a tile stops at column 80, so no
    neighbouring head's values come in); the output and the gradients keep
    that layout, and each head's 80 columns, written by its own CTAs, are
    the same bits as on contiguous copies and within the bf16 limits of the
    plain version, so no CTA writes into a neighbouring head's columns."""
    from chip_smoke import grad_check
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(8)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(torch.bfloat16)
    x, kv, vv, do = mk(2, 300, 4, 80), mk(2, 300, 4, 80), mk(2, 300, 4, 80), mk(2, 300, 4, 80)
    q, k, v, dot = (a.transpose(1, 2) for a in (x, kv, vv, do))
    assert q.stride()[1] == 80 and all(_kernel_ready(a) is a for a in (q, k, v, dot))
    got = flash_attention_cuda(q, k, v)
    assert got.transpose(1, 2).is_contiguous()
    contiguous = [a.contiguous() for a in (q, k, v, dot)]
    assert torch.equal(got, flash_attention_cuda(*contiguous[:3]))
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    assert _row_rel_err(got, want) <= FLASH_ROW_TOL
    grads = flash_attention_bwd_cuda(q, k, v, dot)
    for a, b_, w, x_ in zip(grads, flash_attention_bwd_cuda(*contiguous),
                            flash_attention_bwd_plain(q, k, v, dot), (q, k, v)):
        assert a.stride() == x_.stride() and torch.equal(a, b_)
        assert grad_check(a, w)["ok"]


def test_flash_hd80_baselines_stay_callable(dev):
    """The kernels hd 80 ran before the wgmma route stay callable,
    uncounted, for the smoke's side-by-side timing (the 'mma' forward
    through ``_launch(ROUTES["mma"], ...)``, the 'scalar' backward through
    ``_bwd_launch("scalar", ...)``): each holds against the plain version,
    and the wgmma routes agree with them per output row within the bf16
    limits."""
    from chip_smoke import grad_check
    from repro_torch.kernels.flash_attention import (_bwd_launch, flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain)

    q, k, v = _flash_inputs(dev, torch.bfloat16, 2, 4, 4, 300, 300, 80)
    do = _flash_inputs(dev, torch.bfloat16, 2, 4, 4, 300, 1, 80, seed=12)[0]
    before = dict(_build.LAUNCHES)
    base = flash_launch(ROUTES["mma"], q, k, v, True, 0, 0.0)
    base_g = _bwd_launch("scalar", q, k, v, do, True, 0, 0.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(base.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    got = flash_attention_cuda(q, k, v)
    torch.testing.assert_close(got.float(), base.float(), **FLASH_TOL[torch.bfloat16])
    assert _row_rel_err(got, base) <= FLASH_ROW_TOL
    want_g = flash_attention_bwd_plain(q, k, v, do)
    for a, b_, w in zip(flash_attention_bwd_cuda(q, k, v, do), base_g, want_g):
        assert grad_check(b_, w)["ok"] and grad_check(a, b_)["ok"]


@pytest.mark.parametrize("arch,dtype", [("gemma2-9b", "float32"), ("gemma2-9b", "bfloat16"),
                                        ("qwen2-moe-a2.7b", "float32"),
                                        ("zamba2-2.7b", "float32"), ("zamba2-2.7b", "bfloat16"),
                                        ("rwkv6-3b", "float32"), ("rwkv6-3b", "bfloat16")])
def test_reduced_family_prefill_on_card_matches_cpu(dev, arch, dtype):
    """A reduced gemma2 (hd 256, window 100 in a 300-token prompt), a
    reduced qwen2-moe (hd 128, the MoE's grouped dispatch), a reduced zamba2
    (one group: two mamba2 layers and the shared block at hd 80, H = Hkv,
    through the wgmma forward) and a reduced rwkv6 (no attention) prefill on
    the card, through the kernel once per attention application, against the
    same weights on the CPU: f32 at 1e-4 (cuBLAS's and the kernels' f32 sums
    in other orders; the logits, the KV cache, and every other decode state
    within 1e-4 of its largest entry), bf16 at 3e-2 in relative L2 (the two
    routes round different numbers). zamba2 in bf16 is held relative to the
    CPU's bf16 route: the card's logits no further than 1.25x from the same
    weights in f32 (its seed-initialised stack amplifies rounding; ROADMAP.md,
    the tolerance notes)."""
    import dataclasses

    from chip_smoke import attn_applications
    from repro_torch.configs import get_config
    from repro_torch.models.model import TransformerLM, init_params, prefill_step

    over = {"gemma2-9b": dict(head_dim=256, sliding_window=100, n_kv_heads=2),
            "qwen2-moe-a2.7b": dict(head_dim=128), "zamba2-2.7b": dict(head_dim=80),
            "rwkv6-3b": {}}[arch]
    cfg = get_config(arch).reduced(n_layers=2, dtype=dtype, **over)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    s = 256 if arch == "qwen2-moe-a2.7b" else 300
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, s)).astype(np.int32)
    ops.reset_launch_counts()
    with torch.inference_mode():
        a, ca = prefill_step(card, torch.as_tensor(prompt, device=dev), s + 4)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == attn_applications(cfg)
        b, cb = prefill_step(cpu, torch.as_tensor(prompt), s + 4)
    assert a.is_cuda and bool(torch.isfinite(a).all())
    rel = lambda x, y: float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
    if dtype == "float32":
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        if "k" in cb:
            torch.testing.assert_close(ca["k"].cpu(), cb["k"], rtol=1e-4, atol=1e-4)
        for key in cb:
            if key != "pos":
                err = float((ca[key].cpu() - cb[key]).abs().max()) / float(cb[key].abs().max())
                assert err <= 1e-4, (key, err)
    elif arch == "zamba2-2.7b":
        f32 = TransformerLM(dataclasses.replace(cfg, dtype="float32"))
        f32.load_state_dict({k_: v_.float() for k_, v_ in cpu.state_dict().items()})
        with torch.inference_mode():
            ref = prefill_step(f32, torch.as_tensor(prompt), s + 4)[0]
        assert rel(a.cpu(), ref) <= 1.25 * rel(b, ref), (rel(a.cpu(), ref), rel(b, ref))
    else:
        assert rel(a.cpu(), b) <= 3e-2


# -- the LM split over rank processes on the card (ROADMAP item 13.6) ---------

_SHARDED_RANK = """
import sys, numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import init_params, lm_loss, prefill_step
from repro_torch.sharding.collectives import MeshComm
from repro_torch.sharding.placement import gather_whole, shard_batch, shard_model
from repro_torch.training.train_step import _sharded_grads
torch.backends.cuda.matmul.allow_tf32 = False
mesh = make_mesh(sys.argv[1])
comm = MeshComm.from_env(mesh)
dev = torch.device("cuda")
cfg = get_config("internlm2-1.8b").reduced(dtype="float32", n_layers=2, head_dim=64,
                                           n_heads=8, n_kv_heads=2)
whole = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                    tp=mesh.shape["model"])
rng = np.random.default_rng(1)
tok, lab = (torch.as_tensor(rng.integers(0, cfg.vocab, (4, 128)), device=dev) for _ in range(2))
loss_w = lm_loss(whole, tok, lab)
grads_w = torch.autograd.grad(loss_w, tuple(whole.parameters()))
model = shard_model(whole, mesh, comm.rank, comm)
loss = lm_loss(model, shard_batch(tok, mesh, comm.rank), shard_batch(lab, mesh, comm.rank))
specs = [model.shard.specs[n] for n, _ in model.named_parameters()]
grads = _sharded_grads(comm, specs, torch.autograd.grad(loss, tuple(model.parameters())))
err = max(float((gather_whole(g, s, comm) - w).abs().max() / w.abs().max())
          for g, s, w in zip(grads, specs, grads_w))
with torch.no_grad():
    lw, _ = prefill_step(whole, tok, 130, tp=mesh.shape["model"])
    ls, _ = prefill_step(model, shard_batch(tok, mesh, comm.rank), 130, tp=mesh.shape["model"])
rows = shard_batch(torch.arange(4, device=dev)[:, None], mesh, comm.rank)[:, 0]
assert grads[0].is_cuda and ls.is_cuda
print("RESULT", float(loss), float(loss_w), err, float((ls - lw[rows]).abs().max()))
comm.shutdown()
"""


def test_row_parallel_f32_product_on_card(dev):
    """``layers.matmul_f32`` on the card (``torch.mm(out_dtype=float32)``
    of bf16 operands) against the widened f32 product, and its gradients
    against autograd through the bf16 ``x @ w`` (bf16 tolerances)."""
    from repro_torch.models.layers import matmul_f32

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(3, 256, 512, generator=g, device=dev).bfloat16().requires_grad_(True)
    w = (torch.randn(512, 384, generator=g, device=dev) / 512 ** 0.5).bfloat16()
    w.requires_grad_(True)
    up = torch.randn(3, 256, 384, generator=g, device=dev).bfloat16()
    out = matmul_f32(x, w)
    wide = x.detach().float() @ w.detach().float()
    assert out.dtype == torch.float32
    assert float((out - wide).norm() / wide.norm()) <= 1e-5
    gx, gw = torch.autograd.grad(out, (x, w), up.float())
    rx, rw = torch.autograd.grad(x @ w, (x, w), up)
    torch.testing.assert_close(gx, rx)
    torch.testing.assert_close(gw, rw)


@pytest.mark.parametrize("mesh_spec", ["2x2", "1x4"])
def test_sharded_lm_on_card_matches_the_whole_model(dev, mesh_spec, tmp_path):
    """Four rank processes on the card (gloo, collectives staged through
    pinned host memory): a reduced internlm2 in f32 at 2 x 2 and 1 x 4 (8
    query and 2 KV heads: at 1 x 4 the expanded cache and gathered K / V
    weights), the sharded loss, gathered gradient and prefill logits
    against the whole model on the same card at the CPU tests' tolerances."""
    from repro_torch.multihost import spawn_ranks

    script = tmp_path / "rank.py"
    script.write_text(_SHARDED_RANK)
    results = spawn_ranks([sys.executable, str(script), mesh_spec], 4, timeout_s=300)
    for r, (code, text) in enumerate(results):
        assert code == 0, f"rank {r} exited with {code}:\n{text}"
        loss, loss_w, err, logit_err = map(float, text.split("RESULT", 1)[1].split()[:4])
        assert abs(loss - loss_w) <= 1e-5 * abs(loss_w), (r, loss, loss_w)
        assert err <= 1e-4, (r, err)
        assert logit_err <= 1e-4, (r, logit_err)
