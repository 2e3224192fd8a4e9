"""The port's LM training slice against the JAX package's, on the CPU.

Inputs come from numpy seeds or from the reference (``repro.models.
init_params``), carried across with ``repro_torch.convert`` (parameters,
Adam moments and step counts as numpy). Tolerances:
- f32 (``reduced(n_layers=2, vocab=128, n_kv_heads=2, dtype="float32")``):
  the loss at rtol 1e-5; every gradient leaf at rtol 1e-5 of its largest
  entry (two implementations of the same f32 arithmetic, summed in other
  orders); per-step loss and grad norm of the train step at rtol 1e-5;
  params after 3 steps at 10 lr absolute (Adam turns a near-zero
  gradient's rounding into a full +-lr step, so params are not held at an
  rtol);
- with int8 compression, step 1 as above, steps 2 and 3 at rtol 1e-3 (loss
  and grad norm): the rounding to int8 levels is discontinuous, so f32
  gradients that agree to ~1e-6 land on neighbouring levels at the
  half-way points (each such entry moves by one quantum, absmax / 127),
  and the error feedback carries that into the next step (measured: 6.1e-4
  on the grad norm of step 2, 4.2e-5 on the loss of step 3). The
  quantization itself is held bitwise on shared inputs;
- bf16: the loss at the reference's 2e-2 (tests/test_training.py). The
  bf16 gradients of the two packages each lie 1-2 % (relative L2 per leaf)
  from the f32 gradient of the same weights, in independent directions
  (the reference's XLA route rounds the attention probabilities to bf16
  before P . V, the port's plain version does not), so they are 1-2.2 %
  from each other: each leaf is held within 3e-2 relative L2 of the
  reference's (the repo's bf16 route tolerance) and no further from the
  reference's f32 gradient than 1.25x the reference's own bf16 gradient;
- ``cosine_warmup``: rtol 1e-6, beside an absolute 2^-23 peak_lr (one f32
  rounding of the cosine term, which near the schedule's end is the whole
  value: the two libraries' f32 cos differ there by an ulp);
- ``adamw_update`` over 10 steps: rtol 1e-6;
- the flash ``autograd.Function`` on the CPU against ``jax.grad`` of
  ``flash_attention_ref`` (GQA by the reference's ``_expand_kv``): 1e-5
  of each gradient's largest entry;
- token streams, converted states and checkpoints: bitwise.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data.tokens import TokenStream as RefTokenStream  # noqa: E402
from repro.kernels.flash_ref import flash_attention_ref  # noqa: E402
from repro.models.attention import _expand_kv  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.optim import adam_init as jadam_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_warmup as jcosine_warmup  # noqa: E402
from repro.training.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro.training.train_step import train_state_init as jtrain_state_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttention  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model import init_params, lm_loss  # noqa: E402
from repro_torch.optim import adam_init, adamw_update, cosine_warmup  # noqa: E402
from repro_torch.training.train_step import make_train_step, train_state_init  # noqa: E402

ARCH = "internlm2-1.8b"
F32 = dict(n_layers=2, vocab=128, n_kv_heads=2, dtype="float32")
BF16 = dict(n_layers=2, vocab=128, n_kv_heads=2)
# The dense global-attention configurations the port runs.
DENSE = ["chameleon-34b", "internlm2-1.8b", "minitron-4b", "mistral-large-123b",
         "musicgen-large"]


def _cfgs(**kw):
    return jconfigs.get_config(ARCH).reduced(**kw), tconfigs.get_config(ARCH).reduced(**kw)


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ref_state_numpy(state):
    """A reference TrainState in convert's numpy layout."""
    return {"params": _np32(state.params),
            "opt": {"step": np.int32(state.opt.step), "mu": _np32(state.opt.mu),
                    "nu": _np32(state.opt.nu)},
            "step": np.int32(state.step)}


def _batch(vocab, b=8, s=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


def _ref_grads(cfg, tree):
    """Reference gradient leaves in the port's parameter order."""
    leaves = convert.tensors_from_reference_tree(convert.param_names(cfg), _np32(tree))
    return [torch.from_numpy(np.array(a)) for a in leaves]


def _close_scaled(got, want, rtol):
    """Every entry within rtol of the largest |entry| of ``want``."""
    got, want = got.detach().float(), want.float()
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (err, scale)


# -- schedule and optimiser ------------------------------------------------

@pytest.mark.parametrize("floor", [0.0, 3e-5])
def test_cosine_warmup_matches_reference(floor):
    peak = 3e-4
    for step in list(range(0, 120)) + list(range(120, 1001, 7)) + [1000, 1200]:
        want = float(jcosine_warmup(step, peak, 100, 1000, floor=floor))
        got = cosine_warmup(step, peak, 100, 1000, floor=floor)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=peak * 2.0 ** -23)


def test_adamw_update_matches_reference_over_ten_steps():
    rng = np.random.default_rng(4)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in params]
    tp = tuple(torch.from_numpy(p.copy()) for p in params)
    jst, tst = jadam_init(jp), adam_init(tp)
    for i in range(10):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        lr = 1e-2 * (1 + i)
        jp, jst = jadamw_update([jnp.asarray(g) for g in grads], jst, jp, lr)
        tp, tst = adamw_update(tuple(torch.from_numpy(g) for g in grads), tst, tp, lr)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(tst.mu + tst.nu, list(jst.mu) + list(jst.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
    assert tst.step == int(jst.step) == 10


# -- the loss and its gradients --------------------------------------------

@pytest.mark.parametrize("over,rtol", [(F32, 1e-5), (BF16, 2e-2)], ids=["f32", "bf16"])
def test_lm_loss_and_gradients_match_reference(over, rtol):
    jcfg, tcfg = _cfgs(**over)
    params = jinit_params(jax.random.key(0), jcfg)
    tok, lab = _batch(jcfg.vocab, b=4)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg)))(params)
    model = convert.lm_params_from_reference(_np32(params), tcfg)
    loss_t = lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()))
    assert loss_t.dtype == torch.float32
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=rtol)
    named = list(model.named_parameters())
    for (name, p), g in zip(named, grads_t):
        assert g.dtype == p.dtype, name
    if tcfg.dtype == "float32":
        for (name, _), g, w in zip(named, grads_t, _ref_grads(tcfg, grads_j)):
            _close_scaled(g, w, rtol)
        return
    j32 = dataclasses.replace(jcfg, dtype="float32")
    grads_32 = jax.jit(jax.grad(lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), j32)))(
        _np32(params))
    rel = lambda a, b: float(torch.linalg.norm(a.float() - b) / torch.linalg.norm(b))
    for (name, _), g, w, w32 in zip(named, grads_t, _ref_grads(tcfg, grads_j),
                                    _ref_grads(tcfg, grads_32)):
        assert rel(g, w) <= 3e-2, (name, rel(g, w))
        assert rel(g, w32) <= 1.25 * rel(w, w32), (name, rel(g, w32), rel(w, w32))


def test_lm_loss_chunks_the_head_and_remat_changes_nothing():
    """S = 1024 runs two 512-token loss chunks; remat on and off give the
    same loss and the same gradients up to the order in which autograd sums
    a residual's two cotangents (1e-6 of each leaf's largest)."""
    _, tcfg = _cfgs(**F32)
    model = init_params(tcfg, torch.Generator().manual_seed(0))
    tok, lab = _batch(tcfg.vocab, b=1, s=1024)
    out = []
    for remat in (True, False):
        model.cfg = dataclasses.replace(tcfg, remat=remat)
        loss = lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        _close_scaled(a, b, 1e-6)
    with pytest.raises(ValueError, match="multiple of 512"):
        lm_loss(model, torch.from_numpy(tok[:, :700]), torch.from_numpy(lab[:, :700]))


# -- the train step ----------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("grad_accum", [1, 4])
def test_train_step_matches_reference_over_three_steps(grad_accum, compress):
    jcfg, tcfg = _cfgs(**F32)
    lr = 3e-3
    jstate = jtrain_state_init(jinit_params(jax.random.key(1), jcfg))
    tstate = convert.train_state_from_reference(_ref_state_numpy(jstate), tcfg)
    jstep = jax.jit(jmake_train_step(jcfg, lr=lr, grad_accum=grad_accum, compress=compress))
    tstep = make_train_step(tcfg, lr=lr, grad_accum=grad_accum, compress=compress)
    jerr = terr = None
    for i in range(3):
        tok, lab = _batch(jcfg.vocab, seed=10 + i)
        if compress:
            jstate, jm, jerr = jstep(jstate, jnp.asarray(tok), jnp.asarray(lab), jerr)
            tstate, tm, terr = tstep(tstate, tok, lab, terr)
        else:
            jstate, jm = jstep(jstate, jnp.asarray(tok), jnp.asarray(lab))
            tstate, tm = tstep(tstate, tok, lab)
        rtol = 1e-3 if compress and i > 0 else 1e-5
        for key in ("loss", "grad_norm"):
            assert tm[key].dtype == torch.float32
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol, err_msg=key)
    assert tstate.step == int(jstate.step) == 3 and tstate.opt.step == int(jstate.opt.step)
    got = convert.train_state_to_reference(tstate, tcfg)
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(_np32(jstate.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=10 * lr)
    if compress:
        for e in terr:
            assert e.dtype == torch.float32 and bool(torch.isfinite(e).all())


def test_compress_int8_rounds_half_to_even_like_jnp():
    from repro.training.train_step import _compress_int8 as jcompress
    from repro_torch.training.train_step import _compress_int8

    # 127 / 254 * k: t / scale lands on k + 0.5 for the halves.
    g = np.array([254.0, 0.5, 1.5, 2.5, -0.5, -3.5, 100.25], np.float32)
    e = np.zeros_like(g)
    (qj,), (ej,) = jcompress([jnp.asarray(g)], [jnp.asarray(e)])
    (qt,), (et,) = _compress_int8((torch.from_numpy(g),), (torch.from_numpy(e),))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_compress_int8_with_feedback_is_bitwise_the_reference():
    """Three rounds of quantization with error feedback on shared f32
    gradients (one tensor, bf16 gradients as in an unaccumulated bf16 step,
    a scalar-sized one): bitwise the reference's."""
    from repro.training.train_step import _compress_int8 as jcompress
    from repro_torch.training.train_step import _compress_int8

    rng = np.random.default_rng(6)
    shapes = [(64, 48), (300,), (1,)]
    je = [jnp.zeros(s, jnp.float32) for s in shapes]
    te = tuple(torch.zeros(s) for s in shapes)
    for _ in range(3):
        g = [(rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
             for s in shapes]
        jg = [jnp.asarray(g[0]), jnp.asarray(g[1]).astype(jnp.bfloat16), jnp.asarray(g[2])]
        tg = (torch.from_numpy(g[0]), torch.from_numpy(g[1]).to(torch.bfloat16),
              torch.from_numpy(g[2]))
        jq, je = jcompress(jg, je)
        tq, te = _compress_int8(tg, te)
        for a, b in zip(tq + te, list(jq) + list(je)):
            assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32)
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_tensor_parallel_step_refuses():
    """tp > 1 runs: a dense stack's step at tp = 2 is its step at tp = 1
    (tp pads only an MoE's experts). The step refuses only a state whose
    experts were not padded for its tp (5 experts at tp = 2, which pads to
    6)."""
    _, tcfg = _cfgs(**F32)
    tok, lab = _batch(tcfg.vocab, b=2, s=32)
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    _, m1 = make_train_step(tcfg, lr=1e-3)(train_state_init(params), tok, lab)
    _, m2 = make_train_step(tcfg, tp=2, lr=1e-3)(train_state_init(params), tok, lab)
    assert float(m1["loss"]) == float(m2["loss"])
    mcfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced(n_experts=5, n_layers=1,
                                                            dtype="float32")
    moe = init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="experts"):
        make_train_step(mcfg, tp=2)(train_state_init(moe), tok, lab)


# The reference's own invariants (tests/test_training.py), mirrored on the
# port's bf16 step; grad accumulation against the full batch in f32, where
# the reference's bound holds: the reference marks its bf16 case an expected
# failure on the CPU (bf16 rounding can move one parameter by one bf16
# quantum past 2e-2, as it does in the port: 0.02002 on 1 of 361,088).

@pytest.fixture(scope="module")
def setup():
    _, tcfg = _cfgs(n_layers=2, vocab=128)
    model = init_params(tcfg, torch.Generator().manual_seed(0))
    tok, lab = _batch(tcfg.vocab)
    return tcfg, model, tok, lab


def test_loss_decreases(setup):
    cfg, model, tok, lab = setup
    step, state = make_train_step(cfg, lr=1e-2), train_state_init(model)
    losses = []
    for _ in range(8):
        state, m = step(state, tok, lab)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


def test_grad_accum_matches_full_batch(setup):
    """accum=4 microbatching gives the update of accum=1 (f32 params)."""
    cfg, _, tok, lab = setup
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    s1, m1 = make_train_step(cfg, lr=1e-2, grad_accum=1)(train_state_init(model), tok, lab)
    s4, m4 = make_train_step(cfg, lr=1e-2, grad_accum=4)(train_state_init(model), tok, lab)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=2e-2)
    flat = lambda s: torch.cat([p.float().ravel() for p in s.params])
    np.testing.assert_allclose(flat(s1).numpy(), flat(s4).numpy(), atol=2e-2)


def test_compression_error_feedback(setup):
    cfg, model, tok, lab = setup
    step, state, err = make_train_step(cfg, lr=1e-2, compress=True), train_state_init(model), None
    losses = []
    for _ in range(8):
        state, m, err = step(state, tok, lab, err)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses
    assert math.isfinite(float(torch.sqrt(sum(torch.sum(e * e) for e in err))))


def test_opt_state_is_fp32(setup):
    cfg, model, _, _ = setup
    state = train_state_init(model)
    assert all(m.dtype == torch.float32 for m in state.opt.mu + state.opt.nu)
    assert {p.dtype for p in state.params} == {torch.bfloat16, torch.float32}


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_finite_and_grad_flows(arch):
    """tests/test_models_smoke.py's training case, for the dense archs."""
    cfg = tconfigs.get_config(arch).reduced(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)))
    labels = torch.roll(toks, -1, dims=1)
    loss = lm_loss(model, toks, labels)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert math.isfinite(float(loss))
    assert 0.5 * math.log(cfg.vocab) < float(loss) < 2.5 * math.log(cfg.vocab), float(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(float(torch.sum(g.float() ** 2)) for g in grads) > 0.0


# -- gemma2 and the MoE stacks ----------------------------------------------

# Reduced f32 configurations of the new families: gemma2's window cut to 16
# so that it binds in the 64-token batches; the MoE stacks at reduced()'s
# 4 experts top-2 (their loss carries the router's aux term); zamba2 at
# reduced()'s 4 mamba2 layers in 2 groups, so that the shared block's
# gradient sums two applications; rwkv6 at 2 layers.
FAMILIES = {"gemma2-9b": dict(sliding_window=16, n_kv_heads=2),
            "qwen2-moe-a2.7b": dict(),
            "dbrx-132b": dict(n_kv_heads=2),
            "zamba2-2.7b": dict(n_layers=4),
            "rwkv6-3b": dict()}
# Gradient leaves are held at 1e-5 of their largest entry, zamba2's at
# 2.5e-4: its f32 gradient is ill-conditioned, the embedding's most. Readings
# (tests/_torch_ssm_floor.py, on the CPU): at S = 64 the reference against
# itself with its SSD chunk at 32 / 16 instead of 128 moves by 5.8e-5 /
# 4.7e-5 of the largest entry (the port: 1.7e-5 / 1.1e-5), port against
# reference 9.6e-5; at S = 256, against an f64 evaluation of the same loss,
# the port's f32 gradient lies 8.3e-5 off and the reference's
# token-by-token form (tests/test_torch_recurrent.py) 4.0e-5, and they lie
# 1.2e-4 from each other: the two roundings added.
GRAD_RTOL = {"zamba2-2.7b": 2.5e-4}
# The train step's loss and grad norm after the first step, (loss, grad
# norm) rtol where not 1e-5: Adam's first update is lr g / (|g| + eps), so
# an entry whose gradient is near eps or near zero moves by up to 2 lr on a
# rounding of g. Readings (tests/_torch_ssm_floor.py, lr 3e-3): the
# reference against itself with the SSD chunk at 32 instead of 128 (rwkv6:
# WKV chunk 8, not 16) moves zamba2's loss by 2.3e-6 / 1.7e-5 and its grad
# norm by 2.4e-3 / 5.2e-3 at steps 2 / 3, rwkv6's grad norm by 1.1e-6 /
# 2.5e-6; the port against the reference reads 2.0e-7 / 3.2e-5 and 9.2e-4
# / 2.9e-3 (zamba2), 1.4e-5 / 5.9e-7 (rwkv6's grad norm).
STEP_RTOL = {"zamba2-2.7b": (1e-4, 1e-2), "rwkv6-3b": (1e-5, 1e-4)}


def _family_cfgs(arch, **kw):
    kw = {**dict(n_layers=2, vocab=128, dtype="float32"), **FAMILIES[arch], **kw}
    return jconfigs.get_config(arch).reduced(**kw), tconfigs.get_config(arch).reduced(**kw)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_families_lm_loss_and_gradients_match_reference(arch):
    """The loss (with the MoE's aux term) at rtol 1e-5 and every gradient
    leaf within 1e-5 of its largest entry (zamba2: ``GRAD_RTOL``), gemma2's
    tied embedding included (its gradient sums the lookup's and the
    head's), zamba2's shared block too (two applications)."""
    jcfg, tcfg = _family_cfgs(arch)
    params = jinit_params(jax.random.key(0), jcfg)
    tok, lab = _batch(jcfg.vocab, b=4)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg)))(params)
    model = convert.lm_params_from_reference(_np32(params), tcfg)
    loss_t = lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    for (name, _), g, w in zip(model.named_parameters(), grads_t, _ref_grads(tcfg, grads_j)):
        _close_scaled(g, w, GRAD_RTOL.get(arch, 1e-5))
    if tcfg.tie_embeddings:
        assert "lm_head" not in dict(model.named_parameters())
    if tcfg.n_experts:
        # The aux term: the same difference between aux_weight 0.01 and 0.
        with torch.no_grad():
            d_t = float(loss_t) - float(lm_loss(model, torch.from_numpy(tok),
                                                torch.from_numpy(lab), aux_weight=0.0))
        d_j = float(loss_j) - float(jlm_loss(params, jnp.asarray(tok), jnp.asarray(lab), jcfg,
                                             aux_weight=0.0))
        assert d_t > 0
        np.testing.assert_allclose(d_t, d_j, rtol=1e-3)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_families_train_step_matches_reference_over_three_steps(arch):
    jcfg, tcfg = _family_cfgs(arch)
    lr = 3e-3
    jstate = jtrain_state_init(jinit_params(jax.random.key(1), jcfg))
    tstate = convert.train_state_from_reference(_ref_state_numpy(jstate), tcfg)
    jstep = jax.jit(jmake_train_step(jcfg, lr=lr))
    tstep = make_train_step(tcfg, lr=lr)
    for i in range(3):
        tok, lab = _batch(jcfg.vocab, seed=10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(tok), jnp.asarray(lab))
        tstate, tm = tstep(tstate, tok, lab)
        rtols = STEP_RTOL.get(arch, (1e-5, 1e-5)) if i else (1e-5, 1e-5)
        for key, rtol in zip(("loss", "grad_norm"), rtols):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol, err_msg=key)
    got = convert.train_state_to_reference(tstate, tcfg)
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(_np32(jstate.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=10 * lr)


def test_reference_moe_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A reference train state of the reduced qwen2-moe (bf16), saved by
    ``repro.ckpt.save_checkpoint``, resumes in ``launch.train.main`` bitwise and
    takes its next step at the reference's loss (2e-2, bf16)."""
    arch = "qwen2-moe-a2.7b"
    jcfg = jconfigs.get_config(arch).reduced()
    jstate = jtrain_state_init(jinit_params(jax.random.key(0), jcfg))
    stream = RefTokenStream(jcfg.vocab, 2, 32, seed=17)
    jstep = jax.jit(jmake_train_step(jcfg, lr=3e-4))
    jstate, _ = jstep(jstate, *map(jnp.asarray, stream.next()))
    path = jckpt.save_checkpoint(str(tmp_path), 1, jstate, {"stream": stream.state_dict()})

    tcfg = tconfigs.get_config(arch).reduced()
    names = convert.param_names(tcfg)
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


def test_cli_trains_gemma2_with_a_layer_override_on_cpu():
    log = []
    state = ttrain.main(["--arch", "gemma2-9b", "--reduced", "--override", "n_layers=2",
                         "--device", "cpu", "--steps", "2", "--batch", "1", "--seq", "64"],
                        log=log)
    assert state.step == 2 and len(state.params) == len(convert.param_names(
        tconfigs.get_config("gemma2-9b").reduced(n_layers=2)))
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in log)


# -- flash attention's gradient on the CPU --------------------------------

FLASH_GRAD_CASES = {
    "causal": (2, 4, 2, 40, 40, 32, True, 0, 0.0),
    "window": (2, 4, 2, 40, 40, 32, True, 7, 0.0),
    "softcap": (1, 4, 4, 33, 33, 64, True, 0, 5.0),
    "short_long": (1, 4, 1, 9, 40, 32, True, 0, 0.0),
    "empty_rows": (1, 2, 1, 30, 10, 32, True, 4, 0.0),
}


@pytest.mark.parametrize("case", sorted(FLASH_GRAD_CASES))
def test_flash_function_gradient_matches_jax_grad(case):
    b, h, hkv, s, t, hd, causal, window, cap = FLASH_GRAD_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(sh).astype(np.float32) * 2
               for sh in ((b, h, s, hd), (b, hkv, t, hd), (b, hkv, t, hd)))
    w = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    n_rep = h // hkv
    expand = lambda x: _expand_kv(x.swapaxes(1, 2), n_rep).swapaxes(1, 2)

    def jfun(q, k, v):
        o = flash_attention_ref(q, expand(k), expand(v), causal=causal, window=window,
                                softcap=cap)
        return jnp.sum(o * w)

    want = jax.grad(jfun, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = FlashAttention.apply(*leaves, causal, window, cap)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(w))
    for g, wj in zip(got, want):
        _close_scaled(g, torch.from_numpy(np.asarray(wj)), 1e-5)


# -- conversion and checkpoints ----------------------------------------------

def test_train_state_conversion_round_trips_bitwise():
    jcfg, tcfg = _cfgs(**BF16)
    jstate = jtrain_state_init(jinit_params(jax.random.key(2), jcfg))
    jstate, _ = jax.jit(jmake_train_step(jcfg, lr=1e-2))(jstate, *map(jnp.asarray,
                                                                     _batch(jcfg.vocab)))
    tree = _ref_state_numpy(jstate)
    tstate = convert.train_state_from_reference(tree, tcfg)
    assert tstate.params[0].dtype == torch.bfloat16 and tstate.opt.mu[0].dtype == torch.float32
    back = convert.train_state_to_reference(tstate, tcfg)
    assert back["step"] == tree["step"] == 1 and back["opt"]["step"] == 1
    flat_a, flat_b = jax.tree.leaves(back), jax.tree.leaves(tree)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cli(tmp, *extra):
    return ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp), *extra]


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A reference TrainState saved by ``repro.ckpt.save_checkpoint`` (the
    reference driver's layout and extras) resumes in the port's driver at
    the same step and stream position, with the same state bitwise."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    jstate = jtrain_state_init(jinit_params(jax.random.key(0), jcfg))
    stream = RefTokenStream(jcfg.vocab, 2, 32, seed=17)
    jstep = jax.jit(jmake_train_step(jcfg, lr=3e-4))
    for _ in range(2):
        jstate, _ = jstep(jstate, *map(jnp.asarray, stream.next()))
    path = jckpt.save_checkpoint(str(tmp_path), 2, jstate, {"stream": stream.state_dict()})

    tcfg = tconfigs.get_config(ARCH).reduced()
    names = convert.param_names(tcfg)
    template = train_state_init(init_params(tcfg, torch.Generator().manual_seed(5)))
    restored, manifest = ttrain.restore_state(path, template, names, "cpu")
    want = _ref_state_numpy(jstate)
    got = convert.train_state_to_reference(restored, tcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert manifest["extras"]["stream"] == {"batch_idx": 2, "seed": 17}

    log = []
    state = ttrain.main(_cli(tmp_path, "--steps", "1", "--resume"), log=log)
    assert f"resumed from {path} at step 2" in capsys.readouterr().out
    assert state.step == 3 and [r["step"] for r in log] == [3]
    # The reference's third step on the third batch, from the same state.
    _, jm = jstep(jstate, *map(jnp.asarray, stream.next()))
    np.testing.assert_allclose(log[0]["loss"], float(jm["loss"]), rtol=2e-2)
    _, m3 = jckpt.load_checkpoint(jckpt.latest_checkpoint(str(tmp_path)))
    assert m3["step"] == 3 and m3["extras"]["stream"] == {"batch_idx": 3, "seed": 17}


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    state = ttrain.main(_cli(tmp_path, "--steps", "2", "--ckpt-every", "1"))
    path = jckpt.latest_checkpoint(str(tmp_path))
    jcfg = jconfigs.get_config(ARCH).reduced()
    template = jtrain_state_init(jinit_params(jax.random.key(9), jcfg))
    restored, manifest = jckpt.restore_train_state(path, template)
    assert manifest["step"] == 2 and int(restored.step) == 2 and int(restored.opt.step) == 2
    assert jax.tree.leaves(restored.params)[0].dtype == jnp.bfloat16
    got = _ref_state_numpy(restored)
    want = convert.train_state_to_reference(state, convert_cfg := tconfigs.get_config(ARCH)
                                            .reduced())
    assert convert_cfg.dtype == "bfloat16"
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    stream = RefTokenStream(jcfg.vocab, 2, 32, seed=0)
    stream.load_state_dict(manifest["extras"]["stream"])
    assert stream.batch_idx == 2 and stream.seed == 17


def test_cli_trains_on_cpu_and_refuses_without_a_card(monkeypatch, capsys):
    log = []
    state = ttrain.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                         "--seq", "32"], log=log)
    assert state.step == 2 and len(log) == 2
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in log)
    assert "[train] done; final loss" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "1"])
    # --mesh 2x2 trains at tp = 2 on the one device and prints its header.
    state = ttrain.main(["--reduced", "--device", "cpu", "--mesh", "2x2", "--steps", "1",
                         "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert state.step == 1 and "[mesh] 2x2 (data=2, model=2) on one device: tp=2" in out
    assert "per device of the mesh (reckoned from the specs): params" in out
