"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe.moe_forward``, on the CPU.

Weights are the reference's ``moe_init`` draws, carried across as float32
numpy; inputs come from numpy seeds. The reduced qwen2-moe (4 experts top-2
and a shared expert) and dbrx (4 experts top-2, no shared expert)
configurations run in f32. Tolerances: the output within 1e-5 of its
largest entry (the same f32 arithmetic summed in other orders: the port
dispatches by index, the reference by one-hot einsums), the aux loss at
rtol 1e-6, gradients within 1e-5 of each leaf's largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import padded_experts as jpadded  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import AttnBlock  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]
# (capacity_factor, n_experts_padded, B, S): reduced()'s capacity factor
# 4.0 (no drops), 1.0 (drops), experts padded 4 -> 6, decode (t = 2). The
# prefill shapes span two groups of 1024 tokens across batch rows.
CASES = {"cf4": (4.0, None, 4, 512), "cf1": (1.0, None, 4, 512),
         "padded": (4.0, 6, 4, 512), "decode": (4.0, None, 2, 1)}


def _cfgs(arch, cf):
    kw = dict(dtype="float32", capacity_factor=cf)
    return jconfigs.get_config(arch).reduced(**kw), tconfigs.get_config(arch).reduced(**kw)


def _layer(arch, cf, n_pad, seed=0):
    jcfg, tcfg = _cfgs(arch, cf)
    params = jmoe.moe_init(jax.random.key(seed), jcfg, jnp.float32, n_pad)
    layer = tmoe.MoE(tcfg, n_pad)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            leaf = params
            for part in name.split("."):
                leaf = leaf[part]
            assert tuple(leaf.shape) == tuple(p.shape), name
            p.copy_(torch.from_numpy(np.array(leaf)))
    return jcfg, params, layer


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close_scaled(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, case):
    cf, n_pad, b, s = CASES[case]
    jcfg, params, layer = _layer(arch, cf, n_pad)
    x = _x(b, s, jcfg.d_model)
    want, aux_want = jax.jit(jmoe.moe_forward, static_argnums=(2, 3))(params, jnp.asarray(x),
                                                                      jcfg, n_pad)
    with torch.no_grad():
        got, aux = layer(torch.from_numpy(x))
        r = layer.routing(torch.from_numpy(x))
    assert got.shape == (b, s, jcfg.d_model) and got.dtype == torch.float32
    _close_scaled(got.numpy(), want, 1e-5)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6)
    kept, chosen = int(r.keep.sum()), int(r.selected.sum())
    assert chosen == b * s * jcfg.n_experts_active
    if case == "cf1":
        assert kept < chosen, "capacity factor 1.0 dropped no assignment"
    else:
        assert kept == chosen
    if n_pad:
        assert layer.n_experts == n_pad and int(r.expert.max()) < jcfg.n_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_reference_with_drops(arch):
    """d(sum(out * w) + aux) for every parameter and the input, against
    ``jax.grad`` of the reference, at capacity factor 1.0 (drops)."""
    jcfg, params, layer = _layer(arch, 1.0, None, seed=2)
    x = _x(4, 512, jcfg.d_model, seed=3)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jfun(p, xx):
        out, aux = jmoe.moe_forward(p, xx, jcfg)
        return jnp.sum(out * w) + aux

    gp, gx = jax.jit(jax.grad(jfun, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layer(xt)
    names, leaves = zip(*layer.named_parameters())
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)) + aux, leaves + (xt,))
    for name, g in zip(names + ("x",), grads):
        if name == "x":
            want = gx
        else:
            want = gp
            for part in name.split("."):
                want = want[part]
        _close_scaled(g.numpy(), want, 1e-5, name)


def test_route_keeps_the_first_maximum_and_the_token_order():
    """Ties go to the lower expert index (``jnp.argmax``); slots count the
    group's tokens in order; the capacity drops the later tokens."""
    logits = torch.zeros(1, 4, 3)
    logits[0, :, 2] = -5.0                       # experts 0 and 1 tie for every token
    r = tmoe.route(logits, e_real=3, k=1, capacity_factor=1.0)
    # capacity = int(1.0 * 4 * 1 / 3) = 1
    assert r.capacity == 1
    assert r.expert[0, :, 0].tolist() == [0, 0, 0, 0]
    assert r.slot[0, :, 0].tolist() == [0, 1, 2, 3]
    assert r.keep[0, :, 0].tolist() == [True, False, False, False]
    assert r.gate[0, :, 0].tolist() == [1.0, 0.0, 0.0, 0.0]


def test_moe_group_size_must_divide_the_tokens():
    _, _, layer = _layer("qwen2-moe-a2.7b", 4.0, None)
    with pytest.raises(ValueError, match="multiple of the group size"):
        layer(torch.zeros(3, 700, layer.cfg.d_model))


@pytest.mark.parametrize("arch", [a for a in tconfigs.ARCHS
                                  if tconfigs.get_config(a).block_kind == "attn"])
def test_block_ffn_matches_reference(arch):
    """A block holds a MoE of the reference's expert count on one device
    (its ``padded_experts(cfg, 1)``: meshes, and padding to their model
    axis, are ROADMAP 13.6), or the dense MLP where there are no experts."""
    block = AttnBlock(tconfigs.get_config(arch), device="meta")
    n = jpadded(jconfigs.get_config(arch), 1)
    if n:
        assert not hasattr(block, "mlp")
        assert block.moe.n_experts == n and block.moe.w_gate.shape[0] == n
        assert block.moe.router.shape[1] == n
    else:
        assert hasattr(block, "mlp") and not hasattr(block, "moe")


def test_moe_init_distributions():
    cfg = dataclasses.replace(tconfigs.get_config("qwen2-moe-a2.7b").reduced(dtype="float32"),
                              d_model=256, moe_d_ff=512)
    layer = tmoe.MoE(cfg)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    layer.requires_grad_(False)
    assert layer.router.dtype == torch.float32
    assert abs(float(layer.router.std()) - 0.02) < 2e-3
    assert abs(float(layer.w_gate.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(layer.w_down.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert layer.shared.w_gate.shape == (256, cfg.shared_d_ff)
    bf = tmoe.MoE(dataclasses.replace(cfg, dtype="bfloat16"), dtype=torch.bfloat16)
    assert bf.router.dtype == torch.float32 and bf.w_up.dtype == torch.bfloat16
