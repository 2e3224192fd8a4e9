"""The zamba2 and rwkv6 training paths against the JAX package's, on the CPU:
ROADMAP fault 9 (the reference's mamba2 gradient is NaN from 128 tokens),
the hybrid's checkpoints crossing between the packages both ways, and the
training CLI on both families. Apart from tests/test_torch_training.py so
that the two files run on separate workers; the helpers, the reduced
configurations and ``GRAD_RTOL`` (zamba2's f32 gradient floor, and where
its readings come from) are that file's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data.tokens import TokenStream as RefTokenStream  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.training.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro.training.train_step import train_state_init as jtrain_state_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model import init_params, lm_loss  # noqa: E402
from repro_torch.training.train_step import train_state_init  # noqa: E402
from test_torch_training import (GRAD_RTOL, _batch, _cli, _close_scaled,  # noqa: E402
                                 _family_cfgs, _np32, _ref_grads, _ref_state_numpy)


def _tokenwise_reference_loss(params, tok, lab, cfg):
    """The reference's zamba2 loss with every mamba2 layer run token by token
    through its own ``mamba2_decode`` (no masked exp anywhere), the shared
    block through ``_attn_block_fwd``, the head through ``logits_fn`` and
    ``cross_entropy``: ``lm_loss`` of one 512-token chunk or less."""
    from repro.models.layers import cross_entropy, rms_norm
    from repro.models.model import embed_tokens, logits_fn
    from repro.models.ssm import mamba2_decode, mamba2_init_cache
    from repro.models.transformer import _attn_block_fwd

    b, s = tok.shape
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    x = embed_tokens(params, tok, cfg)
    stack = params["stack"]
    for i in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], stack["layers"])
        h1 = rms_norm(x, p["ln1"], cfg.norm_eps)

        def step(cache, xt, p=p):
            y, cache = mamba2_decode(p["mamba"], xt[:, None], cache, cfg)
            return cache, y[:, 0]

        _, ys = jax.lax.scan(step, mamba2_init_cache(cfg, b, x.dtype), h1.transpose(1, 0, 2))
        x = x + ys.transpose(1, 0, 2)
        if (i + 1) % cfg.attn_every == 0:
            x, _ = _attn_block_fwd(stack["shared_attn"], x, cfg, jnp.int32(0), positions, 1)
    hidden = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return cross_entropy(logits_fn(params, hidden, cfg), lab, cfg.vocab)


def test_zamba2_gradient_is_finite_where_the_references_is_not():
    """ROADMAP fault 9: at S = 256 (two 128-step SSD chunks) ``jax.grad`` of
    the reference's ``lm_loss`` on the reduced zamba2 is non-finite (its
    ``_ssd_chunk`` takes exp of the unmasked upper triangle, which overflows
    in f32, and then masks it: 0 * inf in the backward), while its loss is
    right. The port masks before the exp: its loss equals the reference's
    (rtol 1e-5) and its gradient is finite and within ``GRAD_RTOL`` (the
    f32 floor of this configuration) of ``jax.grad`` of the same loss built
    token by token from the reference's ``mamba2_decode``."""
    jcfg, tcfg = _family_cfgs("zamba2-2.7b")
    params = jinit_params(jax.random.key(0), jcfg)
    tok, lab = _batch(jcfg.vocab, b=2, s=256, seed=4)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg)))(params)
    bad = sum(not np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(grads_j))
    assert np.isfinite(float(loss_j)) and bad > 0
    loss_w, grads_w = jax.jit(jax.value_and_grad(
        lambda p: _tokenwise_reference_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg)))(params)
    model = convert.lm_params_from_reference(_np32(params), tcfg)
    loss_t = lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(loss_w), float(loss_j), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads_t)
    for g, w in zip(grads_t, _ref_grads(tcfg, grads_w)):
        _close_scaled(g, w, GRAD_RTOL["zamba2-2.7b"])


def test_reference_hybrid_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A reference train state of the reduced zamba2 (bf16: 4 mamba2 layers
    and the shared block under ``stack/shared_attn``), saved by
    ``repro.ckpt.save_checkpoint``, resumes in ``launch.train.main`` bitwise
    and takes its next step at the reference's loss (2e-2, bf16)."""
    arch = "zamba2-2.7b"
    jcfg = jconfigs.get_config(arch).reduced()
    jstate = jtrain_state_init(jinit_params(jax.random.key(0), jcfg))
    stream = RefTokenStream(jcfg.vocab, 2, 32, seed=17)
    jstep = jax.jit(jmake_train_step(jcfg, lr=3e-4))
    jstate, _ = jstep(jstate, *map(jnp.asarray, stream.next()))
    path = jckpt.save_checkpoint(str(tmp_path), 1, jstate, {"stream": stream.state_dict()})

    tcfg = tconfigs.get_config(arch).reduced()
    names = convert.param_names(tcfg)
    assert "shared_attn.attn.wq" in names
    template = train_state_init(init_params(tcfg, torch.Generator().manual_seed(5)))
    restored, _ = ttrain.restore_state(path, template, names, "cpu")
    got = convert.train_state_to_reference(restored, tcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_ref_state_numpy(jstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    log = []
    state = ttrain.main(["--arch", arch] + _cli(tmp_path, "--steps", "1", "--resume"), log=log)
    assert f"resumed from {path} at step 1" in capsys.readouterr().out
    assert state.step == 2
    _, jm = jstep(jstate, *map(jnp.asarray, stream.next()))
    np.testing.assert_allclose(log[0]["loss"], float(jm["loss"]), rtol=2e-2)


def test_port_hybrid_checkpoint_resumes_in_the_reference(tmp_path):
    """The port's checkpoint of the reduced zamba2 restores in
    ``repro.ckpt.restore_train_state`` bitwise, its shared block included."""
    arch = "zamba2-2.7b"
    state = ttrain.main(["--arch", arch] + _cli(tmp_path, "--steps", "2", "--ckpt-every", "1"))
    path = jckpt.latest_checkpoint(str(tmp_path))
    jcfg = jconfigs.get_config(arch).reduced()
    template = jtrain_state_init(jinit_params(jax.random.key(9), jcfg))
    restored, manifest = jckpt.restore_train_state(path, template)
    assert manifest["step"] == 2 and int(restored.step) == 2
    assert "shared_attn" in restored.params["stack"]
    got = _ref_state_numpy(restored)
    want = convert.train_state_to_reference(state, tconfigs.get_config(arch).reduced())
    assert len(jax.tree.leaves(got)) == len(jax.tree.leaves(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_cli_trains_the_recurrent_families_on_cpu(arch):
    log = []
    state = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                         "--batch", "1", "--seq", "64"], log=log)
    assert state.step == 2 and len(state.params) == len(convert.param_names(
        tconfigs.get_config(arch).reduced()))
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in log)
