"""The flash-attention backward's route table and the row statistics its
'wgmma' route reads (``repro_torch.kernels.flash_attention``), on the CPU.

The statistics of the plain version (``flash_attention_plain(...,
return_stats=True)``: each query row's max m of its masked scores in log2
units and 1 / l) are held against ``jax.scipy.special.logsumexp`` of the
reference's masked scores, the scores of ``repro.kernels.flash_ref`` (whose
softmax is checked to give the reference's output), to 1e-6: m ln 2 -
log(1 / l) is the row's logsumexp, both sides summing f32 scores. Rows with
no allowed key keep m = -1e30 exactly and 1 / l = 1 / T. Inputs are made
with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.scipy.special import logsumexp

torch = pytest.importorskip("torch")

from repro.kernels.flash_ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "scalar"), (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 32, "scalar"), (torch.float32, 64, "scalar"), (torch.float32, 80, "scalar"),
    (torch.float32, 128, "scalar"), (torch.float32, 256, "scalar"),
])
def test_bwd_route_table(dtype, hd, route):
    assert tflash.flash_bwd_route(dtype, hd) == route


@pytest.mark.parametrize("dtype,hd,exc", [
    (torch.bfloat16, 96, ValueError), (torch.float32, 16, ValueError),
    (torch.float16, 128, TypeError), (torch.float64, 64, TypeError),
])
def test_bwd_route_raises_outside_the_table(dtype, hd, exc):
    with pytest.raises(exc):
        tflash.flash_bwd_route(dtype, hd)


def _masked_scores(q, k, causal, window, softcap):
    """The reference's masked scores: ``flash_attention_ref``'s, line for
    line (src/repro/kernels/flash_ref.py)."""
    hd, s, t = q.shape[3], q.shape[2], k.shape[2]
    scores = jnp.einsum("bhsd,bhtd->bhst", q, k) * (hd ** -0.5)
    if softcap > 0.0:
        scores = softcap * jnp.tanh(scores / softcap)
    dist = jnp.arange(s)[:, None] - jnp.arange(t)[None, :]
    allow = jnp.ones((s, t), bool)
    if causal:
        allow = allow & (dist >= 0)
    if window > 0:
        allow = allow & (dist < window)
    return jnp.where(allow[None, None], scores, -1e30), np.asarray(allow)


# (B, H, Hkv, S, T, hd, causal, window, softcap)
STATS_CASES = [
    (2, 4, 2, 37, 37, 16, True, 0, 0.0),      # causal, GQA
    (1, 2, 2, 40, 40, 32, True, 7, 0.0),      # window
    (1, 4, 1, 33, 33, 16, True, 0, 3.0),      # softcap, n_rep 4
    (1, 2, 1, 30, 30, 16, True, 9, 2.5),      # window and softcap
    (1, 2, 2, 12, 45, 16, False, 0, 0.0),     # S < T, not causal
    (1, 2, 2, 40, 10, 16, True, 4, 0.0),      # rows with no allowed key
    (1, 2, 1, 40, 10, 16, False, 4, 5.0),     # the same, not causal, softcap
    (1, 4, 2, 60, 60, 256, True, 20, 50.0),   # hd 256 (gemma2): window and softcap
    (1, 2, 1, 64, 12, 256, True, 5, 50.0),    # hd 256: rows with no allowed key
    (2, 4, 4, 70, 70, 80, True, 0, 0.0),      # hd 80 (zamba2): H = Hkv, causal
    (1, 4, 2, 50, 50, 80, True, 12, 30.0),    # hd 80: window and softcap, GQA
    (1, 2, 1, 40, 9, 80, True, 4, 0.0),       # hd 80: rows with no allowed key
]


@pytest.mark.parametrize("case", STATS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_stats_match_reference_logsumexp(case):
    b, h, hkv, s, t, hd, causal, window, cap = case
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((b, h, s, hd), dtype=np.float32)
    k = rng.standard_normal((b, hkv, t, hd), dtype=np.float32)
    v = rng.standard_normal((b, hkv, t, hd), dtype=np.float32)
    out, stats = tflash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                              causal=causal, window=window, softcap=cap,
                                              return_stats=True)
    assert stats.shape == (2, b, h, s) and stats.dtype == torch.float32
    plain = tflash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                         causal=causal, window=window, softcap=cap)
    assert torch.equal(out, plain)  # the statistics leave the output as it was

    kx, vx = (np.repeat(a, h // hkv, axis=1) for a in (k, v))
    scores, allow = _masked_scores(jnp.asarray(q), jnp.asarray(kx), causal, window, cap)
    # These are the reference's scores: their softmax gives its output.
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("bhst,bhtd->bhsd", jax.nn.softmax(scores, axis=-1), vx)),
        np.asarray(flash_attention_ref(jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx),
                                       causal=causal, window=window, softcap=cap)),
        rtol=1e-6, atol=1e-6)
    lse = np.asarray(logsumexp(scores, axis=-1), np.float64)

    m, inv_l = (stats[i].double().numpy() for i in range(2))
    some = np.broadcast_to(allow.any(axis=1), m.shape)
    np.testing.assert_allclose((m * np.log(2.0) - np.log(inv_l))[some], lse[some], rtol=1e-6,
                               atol=1e-6)
    assert (stats[0].numpy()[~some] == np.float32(-1e30)).all()
    np.testing.assert_allclose(inv_l[~some], 1.0 / t, rtol=1e-6)
    assert (~some).any() == (window > 0 and s > t - 1 + window)


def test_kernel_stats_keeps_the_forwards_buffer_and_pads_others():
    """The backward reads the forward's padded (2, B, H, stats_rows(S))
    buffer as it is; statistics in any other layout are copied into one."""
    b, h, s = 2, 3, 130
    r = tflash.stats_rows(s)
    assert r == 256 and tflash.stats_rows(128) == 128 and tflash.stats_rows(1) == 128
    buf = torch.randn(2, b, h, r)
    view = buf[..., :s]
    assert tflash._kernel_stats(view, b, h, s, view.device) is view
    plain = torch.randn(2, b, h, s)
    got = tflash._kernel_stats(plain, b, h, s, plain.device)
    assert got.shape == (2, b, h, r) and torch.equal(got[..., :s], plain)
    with pytest.raises(ValueError, match="stats"):
        tflash._kernel_stats(plain[..., 1:], b, h, s, plain.device)
    with pytest.raises(ValueError, match="stats"):
        tflash._kernel_stats(plain.double(), b, h, s, plain.device)


def test_stats_only_from_the_wgmma_forward():
    """``return_stats`` on a route other than the wgmma forward raises
    before anything launches."""
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma"):
        tflash.flash_attention_cuda(q, q, q, return_stats=True)
    q32 = torch.zeros(1, 2, 8, 128)
    with pytest.raises(ValueError, match="wgmma"):
        tflash.flash_attention_cuda(q32, q32, q32, return_stats=True)


def test_flash_function_on_cpu_differentiates_the_plain_version():
    """On CPU tensors ``FlashAttention`` saves no statistics and its
    gradients are autograd's through the plain version."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).requires_grad_(True)
               for sh in ((1, 4, 20, 64), (1, 2, 20, 64), (1, 2, 20, 64)))
    do = torch.from_numpy(rng.standard_normal((1, 4, 20, 64), dtype=np.float32))
    o = tflash.FlashAttention.apply(q, k, v, True, 5, 0.0)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = tflash.flash_attention_bwd_plain(q, k, v, do, True, 5, 0.0)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_flash_function_hd256_window_softcap_matches_jax_grad():
    """``FlashAttention.apply`` at hd 256 with a window and a softcap
    (gemma2's attention at a reduced size, GQA at n_rep 2) on the CPU
    against ``jax.grad`` of the reference's ``flash_attention_ref`` (the
    reference's backward: it differentiates its XLA route), to 1e-5. Inputs
    are made with numpy from a seed and handed to both packages."""
    b, h, hkv, s, hd, window, cap = 1, 4, 2, 48, 256, 16, 50.0
    rng = np.random.default_rng(24)
    q = rng.standard_normal((b, h, s, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, hkv, s, hd), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal((b, h, s, hd), dtype=np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tflash.FlashAttention.apply(*leaves, True, window, cap)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def loss(q_, k_, v_):
        kx, vx = (jnp.repeat(a, h // hkv, axis=1) for a in (k_, v_))
        o = flash_attention_ref(q_, kx, vx, causal=True, window=window, softcap=cap)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", [(2, 4, 4, 40, 0, 0.0), (1, 4, 2, 48, 16, 30.0)],
                         ids=["zamba2-causal", "window-softcap-gqa"])
def test_flash_function_hd80_matches_jax_grad(case):
    """``FlashAttention.apply`` at hd 80 (zamba2's shared attention at a
    reduced size: H = Hkv, causal; and with a window, a softcap and GQA at
    n_rep 2) on the CPU against ``jax.grad`` of the reference's
    ``flash_attention_ref``, to 1e-5. Inputs are made with numpy from a seed
    and handed to both packages."""
    b, h, hkv, s, window, cap = case
    hd = 80
    rng = np.random.default_rng(80 + window)
    q = rng.standard_normal((b, h, s, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, hkv, s, hd), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal((b, h, s, hd), dtype=np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tflash.FlashAttention.apply(*leaves, True, window, cap)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def loss(q_, k_, v_):
        kx, vx = (jnp.repeat(a, h // hkv, axis=1) for a in (k_, v_))
        o = flash_attention_ref(q_, kx, vx, causal=True, window=window, softcap=cap)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
