"""The port's LM serving path against the JAX package's, on the CPU.

The reference draws its weights (``repro.models.init_params``) and
``repro_torch.convert.lm_params_from_reference`` carries them across as
float32 numpy leaves; prompts are numpy from a seed. Reduced configurations
override ``n_kv_heads=2`` where the config is GQA, so that n_rep > 1 is
exercised (``reduced()`` sets every head count to 4). Tolerances: 1e-4 in
f32 (two implementations of the same f32 arithmetic, summed in other
orders), 3e-2 in bf16 (the reference's flash-vs-XLA prefill tolerance,
tests/test_flash_integration.py), 2e-3 for decode against a longer prefill
(tests/test_models_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.training.serve import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import (init_params, prefill_step, serve_step,  # noqa: E402
                                      TransformerLM)
from repro_torch.training.serve import greedy_generate  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
# MHA by design (musicgen) keeps n_kv_heads = n_heads; it runs at its
# published head_dim of 64 instead of reduced()'s 32.
ARCHS = {
    "internlm2-1.8b": dict(n_kv_heads=2),
    "minitron-4b": dict(n_kv_heads=2),
    "musicgen-large": dict(head_dim=64),
    "mistral-large-123b": dict(n_kv_heads=2),
    "chameleon-34b": dict(n_kv_heads=2),
}
B, S, NEW = 2, 24, 8


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _reduced(arch, **over):
    kw = dict(dtype="float32", **ARCHS[arch])
    kw.update(over)
    return jconfigs.get_config(arch).reduced(**kw), tconfigs.get_config(arch).reduced(**kw)


def _prompt(vocab, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def served(request):
    """One arch's reference run: prefill + NEW - 1 greedy decode steps
    through the reference's own step functions, and the port's model."""
    arch = request.param
    jcfg, tcfg = _reduced(arch)
    params = jinit_params(jax.random.key(7), jcfg)
    prompt = _prompt(jcfg.vocab)
    cache_len = S + NEW
    prefill = jax.jit(make_prefill_step(jcfg, cache_len))
    decode = jax.jit(make_decode_step(jcfg))
    logits, cache = prefill(params, jnp.asarray(prompt))
    ref = {"prefill_logits": np.asarray(logits), "k": np.asarray(cache["k"]),
           "v": np.asarray(cache["v"]), "step_logits": [], "tokens": []}
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    ref["tokens"].append(np.array(tok))
    for _ in range(NEW - 1):
        tok, logits, cache = decode(params, tok, cache)
        ref["step_logits"].append(np.asarray(logits))
        ref["tokens"].append(np.array(tok))
    model = convert.lm_params_from_reference(_np32(params), tcfg)
    return dict(arch=arch, cfg=tcfg, model=model, prompt=prompt, cache_len=cache_len, ref=ref)


def test_prefill_logits_match_reference(served):
    with torch.no_grad():
        logits, _ = prefill_step(served["model"], torch.from_numpy(served["prompt"]),
                                 served["cache_len"])
    np.testing.assert_allclose(logits.numpy(), served["ref"]["prefill_logits"], **F32)


def test_prefill_cache_matches_reference(served):
    with torch.no_grad():
        _, cache = prefill_step(served["model"], torch.from_numpy(served["prompt"]),
                                served["cache_len"])
    assert cache["pos"] == S
    np.testing.assert_allclose(cache["k"].numpy(), served["ref"]["k"], **F32)
    np.testing.assert_allclose(cache["v"].numpy(), served["ref"]["v"], **F32)


def test_decode_logits_match_reference(served):
    """``serve_step`` after a prefill, fed the reference's tokens, at every
    step."""
    ref = served["ref"]
    with torch.no_grad():
        _, cache = prefill_step(served["model"], torch.from_numpy(served["prompt"]),
                                served["cache_len"])
        for tok, want in zip(ref["tokens"], ref["step_logits"]):
            logits, cache = serve_step(served["model"], torch.from_numpy(tok), cache)
            np.testing.assert_allclose(logits.numpy(), want, **F32)


def test_greedy_tokens_match_reference(served):
    """Equal tokens wherever the reference's top-2 logit margin exceeds 1e-3
    (below that, f32 rounding may pick the other token; from there on the
    two sequences part and are not compared)."""
    ref = served["ref"]
    got = greedy_generate(served["model"], torch.from_numpy(served["prompt"]), served["cfg"],
                          NEW, served["cache_len"]).numpy()
    assert got.shape == (B, NEW) and got.dtype == np.int32
    want = np.concatenate(ref["tokens"], axis=1)
    all_logits = [ref["prefill_logits"]] + ref["step_logits"]
    compared = 0
    for b in range(B):
        for j, lg in enumerate(all_logits):
            top2 = np.sort(lg[b])[-2:]
            if top2[1] - top2[0] <= 1e-3:
                break
            assert got[b, j] == want[b, j], (b, j)
            compared += 1
    assert compared >= B * NEW // 2


def test_bf16_internlm2_matches_reference():
    jcfg = jconfigs.get_config("internlm2-1.8b").reduced(n_kv_heads=2)
    tcfg = tconfigs.get_config("internlm2-1.8b").reduced(n_kv_heads=2)
    params = jinit_params(jax.random.key(3), jcfg)
    prompt = _prompt(jcfg.vocab, seed=3)
    logits, cache = jax.jit(make_prefill_step(jcfg, S + 4))(params, jnp.asarray(prompt))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    _, logits2, _ = jax.jit(make_decode_step(jcfg))(params, tok, cache)
    model = convert.lm_params_from_reference(_np32(params), tcfg)
    assert model.embed.dtype == torch.bfloat16 and model.ln_f.dtype == torch.float32
    with torch.no_grad():
        got, tcache = prefill_step(model, torch.from_numpy(prompt), S + 4)
        k_prefill = tcache["k"].float().numpy()   # serve_step writes the cache in place
        got2, _ = serve_step(model, torch.from_numpy(np.array(tok)), tcache)
    tol = dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **tol)
    np.testing.assert_allclose(got2.numpy(), np.asarray(logits2), **tol)
    # bf16 rounding drifts through the layers: the reference's own flash-vs-XLA
    # cache tolerance (tests/test_flash_integration.py).
    np.testing.assert_allclose(k_prefill, np.asarray(cache["k"], np.float32), rtol=8e-2, atol=8e-2)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_kernel_route_matches_never_route(dtype, tol):
    """The flash route (here its plain version, on CPU tensors) against the
    port of ``_attend_block`` (``use_flash="never"``), same weights; S = 1100
    crosses the never route's 1024-query chunk."""
    cfg = tconfigs.get_config("internlm2-1.8b").reduced(dtype=dtype, n_kv_heads=2, n_layers=2)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    never = TransformerLM(dataclasses.replace(cfg, use_flash="never"))
    never.load_state_dict(model.state_dict())
    prompt = torch.from_numpy(_prompt(cfg.vocab, seed=1, b=1, s=1100))
    with torch.no_grad():
        a, ca = prefill_step(model, prompt, 1100)
        b, cb = prefill_step(never, prompt, 1100)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)
    assert torch.equal(ca["k"][0], cb["k"][0])


def test_decode_after_prefill_matches_longer_prefill():
    cfg = tconfigs.get_config("internlm2-1.8b").reduced(dtype="float32", n_kv_heads=2)
    model = init_params(cfg, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_prompt(cfg.vocab, seed=2, s=33))
    with torch.no_grad():
        direct, _ = prefill_step(model, toks, 40)
        _, cache = prefill_step(model, toks[:, :32], 40)
        dec, cache = serve_step(model, toks[:, 32:33], cache)
    assert cache["pos"] == 33
    np.testing.assert_allclose(dec.numpy(), direct.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_param_round_trip_is_bitwise(dtype):
    jcfg = jconfigs.get_config("minitron-4b").reduced(dtype=dtype, n_kv_heads=2)
    tcfg = tconfigs.get_config("minitron-4b").reduced(dtype=dtype, n_kv_heads=2)
    tree = _np32(jinit_params(jax.random.key(5), jcfg))
    back = convert.lm_params_to_reference(convert.lm_params_from_reference(tree, tcfg))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_lm_params_from_reference_rejects_unknown_leaves():
    tcfg = tconfigs.get_config("internlm2-1.8b").reduced(dtype="float32")
    tree = convert.lm_params_to_reference(init_params(tcfg, torch.Generator().manual_seed(0)))
    tree["stack"]["layers"]["moe"] = np.zeros((tcfg.n_layers, 2), np.float32)
    with pytest.raises(ValueError, match="moe"):
        convert.lm_params_from_reference(tree, tcfg)


def test_config_registry_is_a_copy():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for arch, cfg in jconfigs.ARCHS.items():
        assert dataclasses.asdict(tconfigs.get_config(arch)) == dataclasses.asdict(cfg)
        assert dataclasses.asdict(tconfigs.get_config(arch).reduced()) == \
            dataclasses.asdict(cfg.reduced())
        for shape in jconfigs.SHAPES:
            assert tconfigs.applicable(tconfigs.get_config(arch), shape) == \
                jconfigs.applicable(cfg, shape)


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-moe-a2.7b", "dbrx-132b", "zamba2-2.7b",
                                  "rwkv6-3b"])
def test_unported_configurations_raise(arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        TransformerLM(tconfigs.get_config(arch).reduced())


@pytest.mark.parametrize("tp", [1, 2, 4, 16, 32])
def test_cache_expand_factor_matches_reference(tp):
    from repro.models.attention import cache_expand_factor as jfactor
    from repro_torch.models.attention import cache_expand_factor as tfactor
    for arch in ARCHS:
        cfg = jconfigs.get_config(arch)
        assert tfactor(tconfigs.get_config(arch), tp) == jfactor(cfg, tp)


def test_init_params_distributions():
    cfg = tconfigs.get_config("internlm2-1.8b").reduced(dtype="float32", d_model=256, d_ff=512)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    assert abs(float(model.embed.std()) - 0.02) < 1e-3
    assert abs(float(model.lm_head.std()) - 0.02) < 1e-3
    layer = model.layers[0]
    assert abs(float(layer.attn.wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(float(layer.mlp.w_down.std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert float(layer.ln1.abs().max()) == 0.0 and model.ln_f.dtype == torch.float32


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want16 = jlayers.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale), 1e-5)
    got16 = tlayers.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale), 1e-5)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_apply_rope_matches_reference_at_long_positions():
    """theta = 1e6 (internlm2, mistral) and positions up to 4096, the path's
    prompt length. Both packages form f32 angles (up to ~4e3 rad) from
    frequencies equal to within one ulp, and differ mostly in f32 cos/sin:
    the reference's range reduction of such an angle is off by up to about
    one f32 ulp of the angle (2.4e-4 at 4096), the port's is not. So: tight
    at short positions, one angle ulp at long ones, and the port within 1e-5
    of cos/sin of the same angles evaluated in f64."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 3, 128)).astype(np.float32)
    pos = np.stack([np.arange(64), np.arange(4096 - 64, 4096)]).astype(np.int32)
    freqs = tlayers.rope_freqs(128, 1e6).numpy()
    # f32 pow in the two libraries: equal to within one ulp.
    np.testing.assert_array_max_ulp(freqs, np.asarray(jlayers.rope_freqs(128, 1e6)), maxulp=1)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2.5e-4)
    ang = (pos[..., None].astype(np.float32) * freqs).astype(np.float64)[..., None, :]
    x1, x2 = x[..., :64].astype(np.float64), x[..., 64:].astype(np.float64)
    exact = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                            x2 * np.cos(ang) + x1 * np.sin(ang)], axis=-1)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "relu2"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(2)
    p = jlayers.mlp_init(jax.random.key(0), 64, 128, jnp.float32, kind)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    want = np.asarray(jlayers.mlp_apply(p, jnp.asarray(x), kind))
    mlp = tlayers.MLP(64, 128, kind)
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(mlp, name).copy_(torch.from_numpy(np.array(leaf)))
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    want = float(jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 50))
    got = float(tlayers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cli_reduced_on_cpu(capsys):
    toks = tserve.main(["--arch", "internlm2-1.8b", "--reduced", "--batch", "2",
                        "--prompt-len", "32", "--max-new", "8", "--device", "cpu"])
    assert toks.shape == (2, 8) and toks.dtype == torch.int32
    out = capsys.readouterr().out
    assert "[serve] prefill 2x32" in out and "decoded 7 steps x 2 seqs" in out


def test_cli_refuses_without_device_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", "--batch", "1", "--prompt-len", "4", "--max-new", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["gp"])
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--mesh", "2x2", "--device", "cpu"])
