"""The port's flash attention (plain version, the CPU route of
``repro_torch.kernels.flash_attention``) against the JAX package's dense
oracle ``flash_attention_ref`` and its Pallas kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own (tests/test_flash_attention.py): 2e-5 in
f32, 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(seed, b, h, s, t, hd, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, h, s, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, t, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, t, hd), dtype=np.float32))


def _port(arrs, dtype="float32", **kw):
    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs)
    return tflash.flash_attention(q, k, v, **kw).float().numpy()


def _ref(arrs, dtype="float32", **kw):
    q, k, v = (jnp.asarray(a).astype(JAX_DT[dtype]) for a in arrs)
    return np.asarray(flash_attention_ref(q, k, v, **kw), np.float32)


def _pallas(arrs, dtype="float32", q_tile=64, k_tile=64, **kw):
    q, k, v = (jnp.asarray(a).astype(JAX_DT[dtype]) for a in arrs)
    return np.asarray(pallas_flash(q, k, v, q_tile=q_tile, k_tile=k_tile, interpret=True, **kw),
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 128, 128, 32), (2, 3, 256, 256, 64)])
def test_plain_matches_reference_causal(dtype, shape):
    arrs = _qkv(0, *shape)
    np.testing.assert_allclose(_port(arrs, dtype), _ref(arrs, dtype), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 128, 128, 32), (2, 3, 256, 256, 64)])
def test_plain_matches_pallas_interpret(dtype, shape):
    arrs = _qkv(1, *shape)
    np.testing.assert_allclose(_port(arrs, dtype), _pallas(arrs, dtype), **TOL[dtype])


@pytest.mark.parametrize("window", [0, 64, 17])
def test_sliding_window(window):
    arrs = _qkv(2, 1, 2, 128, 128, 32)
    got = _port(arrs, window=window)
    np.testing.assert_allclose(got, _ref(arrs, window=window), **TOL["float32"])
    np.testing.assert_allclose(got, _pallas(arrs, window=window, k_tile=32), **TOL["float32"])


def test_softcap():
    arrs = _qkv(3, 1, 2, 128, 128, 32)
    got = _port(arrs, softcap=30.0)
    np.testing.assert_allclose(got, _ref(arrs, softcap=30.0), **TOL["float32"])
    np.testing.assert_allclose(got, _pallas(arrs, softcap=30.0), **TOL["float32"])


def test_cross_attention_longer_kv():
    """Queries shorter than KV, not causal."""
    arrs = _qkv(4, 2, 2, 64, 512, 32)
    got = _port(arrs, causal=False)
    np.testing.assert_allclose(got, _ref(arrs, causal=False), **TOL["float32"])
    np.testing.assert_allclose(got, _pallas(arrs, causal=False, k_tile=128), **TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_against_reference(causal):
    """S = 100 and T = 37: no tile divides them (the Pallas kernel needs
    S % q_tile == 0); top-left aligned positions with S > T."""
    arrs = _qkv(5, 1, 2, 100, 37, 32)
    np.testing.assert_allclose(_port(arrs, causal=causal), _ref(arrs, causal=causal),
                               **TOL["float32"])
    arrs = _qkv(5, 1, 2, 100, 100, 32)
    np.testing.assert_allclose(_port(arrs, causal=causal), _ref(arrs, causal=causal),
                               **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_reads_kv_head_h_over_n_rep(dtype):
    """Hkv = 2 < H = 6: the port takes the grouped K/V, the reference the
    K/V repeated per query head (``_expand_kv``'s order)."""
    q, k, v = _qkv(6, 2, 6, 96, 96, 32, hkv=2)
    got = _port((q, k, v), dtype)
    want = _ref((q, np.repeat(k, 3, axis=1), np.repeat(v, 3, axis=1)), dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_average_v(causal):
    """With a window and S > T some rows have no allowed key: the -1e30
    sentinel makes them the plain average of V, in the port as in the
    reference (a -inf sentinel would give NaN)."""
    arrs = _qkv(7, 1, 2, 64, 16, 32)
    got = _port(arrs, causal=causal, window=8)
    want = _ref(arrs, causal=causal, window=8)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL["float32"])
    np.testing.assert_allclose(got[:, :, -1], arrs[2].mean(axis=2), rtol=1e-5, atol=1e-5)


def test_kernel_ready_keeps_strided_views_and_copies_misaligned():
    x = torch.zeros(2, 8, 3, 32)                       # (B, S, H, hd)
    view = x.transpose(1, 2)                           # (B, H, S, hd), no copy
    assert tflash._kernel_ready(view) is view
    odd = torch.zeros(2, 3, 8, 33)[..., 1:]            # hd 32 at an offset of 1
    ready = tflash._kernel_ready(odd)
    assert ready is not odd and ready.is_contiguous()


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 32)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_attention_cuda(q, q, q)
    k3 = torch.zeros(1, 3, 8, 32)
    with pytest.raises(ValueError, match="do not divide"):
        tflash.flash_attention(q, k3, k3)
    assert _build.LAUNCHES == before
