"""The port at tp > 1 against the JAX package at the same tp, on the CPU.

In the reference a mesh's 'model' axis of size tp changes two numbers: an
MoE's experts are padded to a multiple of tp (``padded_experts``: padded
experts get router logits of -1e30 and the capacity still counts only the
real ones) and the decode KV cache holds each KV head
``cache_expand_factor(cfg, tp)`` times. The cases below make both happen
on reduced configurations: internlm2 with 8 query and 2 KV heads (tp = 4
expands the cache 2-fold, tp = 2 does not), qwen2-moe with 6 experts at tp
= 4 (padded to 8; once at capacity factor 1.25, where tokens are dropped)
and 5 at tp = 2 (padded to 6), dbrx with both at tp = 4, and the hybrid and
recurrent stacks (zamba2, rwkv6), for which tp changes nothing. The weights
are the reference's ``init_params(key, cfg, tp)``, carried across with
``convert.lm_params_from_reference(..., tp=)``; prompts and batches are
numpy from a seed.

Tolerances are those of tests/test_torch_lm.py and tests/test_torch_training.py:
f32 logits and caches at 1e-4, the loss at rtol 1e-5 and every gradient
leaf at 1e-5 of its largest entry. The expanded cache is held bitwise
against the unexpanded one of the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models.attention import cache_expand_factor as jexpand  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.models.model import make_empty_cache as jmake_empty_cache  # noqa: E402
from repro.models.transformer import padded_experts as jpadded  # noqa: E402
from repro.training.serve import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.attention import cache_expand_factor  # noqa: E402
from repro_torch.models.model import (lm_loss, make_empty_cache, prefill_step,  # noqa: E402
                                      serve_step)
from repro_torch.models.transformer import padded_experts  # noqa: E402
from repro_torch.training.train_step import make_train_step, train_state_init  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
B, S, NEW = 2, 24, 6
# (arch, reduced() overrides, tp)
CASES = [
    ("internlm2-1.8b", dict(n_heads=8, n_kv_heads=2), 2),
    ("internlm2-1.8b", dict(n_heads=8, n_kv_heads=2), 4),
    ("qwen2-moe-a2.7b", dict(n_experts=6), 4),
    ("qwen2-moe-a2.7b", dict(n_experts=6, capacity_factor=1.25), 4),
    ("qwen2-moe-a2.7b", dict(n_experts=5), 2),
    ("dbrx-132b", dict(n_heads=8, n_kv_heads=2, n_experts=6), 4),
    ("zamba2-2.7b", dict(), 2),
    ("rwkv6-3b", dict(), 4),
]
IDS = [f"{a}-{'-'.join(f'{k}{v}' for k, v in o.items()) or 'reduced'}-tp{tp}"
       for a, o, tp in CASES]
ATTN = [c for c in CASES if c[0] not in ("zamba2-2.7b", "rwkv6-3b")]
ATTN_IDS = [i for i, c in zip(IDS, CASES) if c in ATTN]


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _cfgs(arch, over):
    kw = dict(dtype="float32", **over)
    return jconfigs.get_config(arch).reduced(**kw), tconfigs.get_config(arch).reduced(**kw)


def _prompt(vocab, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """The reference's prefill and NEW - 1 greedy decode steps at tp, and
    the port's model on the same weights."""
    arch, over, tp = request.param
    jcfg, tcfg = _cfgs(arch, over)
    params = jinit_params(jax.random.key(11), jcfg, tp)
    prompt = _prompt(jcfg.vocab)
    cache_len = S + NEW
    logits, cache = jax.jit(make_prefill_step(jcfg, cache_len, tp=tp))(params,
                                                                      jnp.asarray(prompt))
    ref = {"prefill_logits": np.asarray(logits), "step_logits": [], "tokens": [],
           "cache": {k: np.asarray(v) for k, v in cache.items() if k != "pos"}}
    decode = jax.jit(make_decode_step(jcfg, tp=tp))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    for _ in range(NEW - 1):
        ref["tokens"].append(np.array(tok))
        tok, logits, cache = decode(params, tok, cache)
        ref["step_logits"].append(np.asarray(logits))
    model = convert.lm_params_from_reference(_np32(params), tcfg, tp=tp)
    return dict(arch=arch, tp=tp, jcfg=jcfg, cfg=tcfg, params=params, model=model,
                prompt=prompt, cache_len=cache_len, ref=ref)


def test_padding_and_expansion_match_reference(case):
    cfg, tp = case["cfg"], case["tp"]
    assert padded_experts(cfg, tp) == jpadded(case["jcfg"], tp)
    assert cache_expand_factor(cfg, tp) == jexpand(case["jcfg"], tp)
    if cfg.n_experts:
        assert case["model"].layers[0].moe.n_experts == padded_experts(cfg, tp)


def test_prefill_logits_and_cache_match_reference(case):
    with torch.no_grad():
        logits, cache = prefill_step(case["model"], torch.from_numpy(case["prompt"]),
                                     case["cache_len"], tp=case["tp"])
    np.testing.assert_allclose(logits.numpy(), case["ref"]["prefill_logits"], **F32)
    want = case["ref"]["cache"]
    assert sorted(cache) == sorted([*want, "pos"]) and cache["pos"] == S
    for key, leaf in want.items():
        assert tuple(cache[key].shape) == leaf.shape, key
        np.testing.assert_allclose(cache[key].numpy(), leaf, err_msg=key, **F32)


def test_decode_logits_match_reference(case):
    """``serve_step`` at tp after the prefill, fed the reference's tokens."""
    ref, tp = case["ref"], case["tp"]
    with torch.no_grad():
        _, cache = prefill_step(case["model"], torch.from_numpy(case["prompt"]),
                                case["cache_len"], tp=tp)
        for tok, want in zip(ref["tokens"], ref["step_logits"]):
            logits, cache = serve_step(case["model"], torch.from_numpy(tok), cache, tp=tp)
            np.testing.assert_allclose(logits.numpy(), want, **F32)


def test_empty_cache_matches_reference(case):
    """``make_empty_cache`` at tp: the reference's leaves, shapes and dtypes
    (K/V heads Hkv r), ``pos`` at the last slot."""
    want = jax.eval_shape(lambda p: jmake_empty_cache(p, case["jcfg"], B, 40, tp=case["tp"]),
                          case["params"])
    got = make_empty_cache(case["model"], B, 40, tp=case["tp"])
    assert sorted(got) == sorted(want) and got["pos"] == 39
    for key, leaf in want.items():
        if key != "pos":
            assert tuple(got[key].shape) == tuple(leaf.shape), key
            assert str(got[key].dtype).split(".")[-1] == str(leaf.dtype), key


@pytest.mark.parametrize("arch,over", [("internlm2-1.8b", dict(n_heads=8, n_kv_heads=2)),
                                       ("dbrx-132b", dict(n_heads=8, n_kv_heads=2))])
def test_expanded_cache_repeats_each_kv_head(arch, over):
    """The same weights at tp = 4 (r = 2) and tp = 1: the expanded cache
    holds each KV head twice in a row, bitwise, and the logits agree."""
    jcfg, tcfg = _cfgs(arch, over)
    model = convert.lm_params_from_reference(_np32(jinit_params(jax.random.key(3), jcfg)), tcfg)
    prompt = torch.from_numpy(_prompt(tcfg.vocab, seed=1))
    with torch.no_grad():
        l1, c1 = prefill_step(model, prompt, S + 2)
        l4, c4 = prefill_step(model, prompt, S + 2, tp=4)
        d1, c1 = serve_step(model, prompt[:, :1], c1)
        d4, c4 = serve_step(model, prompt[:, :1], c4, tp=4)
    assert cache_expand_factor(tcfg, 4) == 2
    for key in ("k", "v"):
        assert c4[key].shape[3] == 2 * c1[key].shape[3]
        assert torch.equal(c4[key][:, :, :, 0::2], c1[key])
        assert torch.equal(c4[key][:, :, :, 1::2], c1[key])
    assert torch.equal(l1, l4)
    np.testing.assert_allclose(d4.numpy(), d1.numpy(), **F32)


@pytest.mark.parametrize("arch,over,tp", ATTN, ids=ATTN_IDS)
def test_loss_and_gradients_match_reference(arch, over, tp):
    """``lm_loss`` at tp (the MoE's aux included) and every gradient leaf,
    padded experts and router columns too (their gradients are zero in
    both), against ``jax.grad`` of the reference's loss at tp."""
    jcfg, tcfg = _cfgs(arch, dict(over, n_layers=2))
    params = jinit_params(jax.random.key(5), jcfg, tp)
    rng = np.random.default_rng(9)
    tok = rng.integers(0, jcfg.vocab, (4, 64)).astype(np.int32)
    lab = rng.integers(0, jcfg.vocab, (4, 64)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg, tp=tp))(params)
    model = convert.lm_params_from_reference(_np32(params), tcfg, tp=tp)
    leaves = tuple(model.parameters())
    loss = lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab), tp=tp)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names = convert.param_names(tcfg, tp)
    want = convert.tensors_from_reference_tree(names, _np32(jgrads))
    for name, g, w in zip(names, grads, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape, name
        scale = float(w.abs().max()) or 1.0
        assert float((g - w).abs().max()) <= 1e-5 * scale, name


def test_train_step_runs_at_tp_and_refuses_a_mismatch():
    """``make_train_step(cfg, tp=4)`` steps a state whose experts are padded
    for tp = 4; a state built for tp = 1 is refused at tp = 4."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", dict(n_experts=6, n_layers=2))
    model = convert.lm_params_from_reference(_np32(jinit_params(jax.random.key(2), jcfg, 4)),
                                             tcfg, tp=4)
    tok = _prompt(tcfg.vocab, seed=4, b=2, s=32)
    state, metrics = make_train_step(tcfg, tp=4, lr=1e-3)(train_state_init(model), tok, tok)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert state.params[0].shape == model.embed.shape
    with pytest.raises(ValueError, match="experts"):
        lm_loss(model, torch.from_numpy(tok), torch.from_numpy(tok), tp=1)
