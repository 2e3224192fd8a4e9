"""The MoE stacks split over a D x M mesh of rank processes (experts over
'model'), against the JAX package and against the port's whole-tensor
runs, on the CPU.

Four gloo ranks (tests/_torch_moe_rank.py, each spawned with its own
timeout) run every case of its ``CASES`` on the reference's
``init_params(key, cfg, tp)`` weights carried across with
``convert.lm_params_from_reference``, while this process computes the
reference's values:

* serving at 1 x 4, reduced qwen2-moe and dbrx (one expert a rank): prefill
  and teacher-forced decode logits against the reference's ``serve_step``;
* the loss with aux and every gathered gradient leaf, reduced qwen2-moe and
  dbrx at 2 x 2 (4 x 512 tokens: one dispatch group a rank) and 1 x 4, and
  6 experts padded to 8 at 1 x 4 (the padded experts' gradients zero),
  against ``jax.value_and_grad`` of the reference's ``lm_loss``; the
  last-token logits of a prefill at both meshes against the whole model's;
* the load-balancing loss at a data split against the whole model's, and
  beyond the mean of the two data ranks' own losses (the planted fault);
* layer 0's MoE alone: the gradients with respect to its input and its
  router against the whole layer's, a planted fault (the router's input
  gradient counted once per model rank) beyond the limit;
* the shard-only initialisation is bitwise the whole weights cut; every
  rank's shard bytes of the full-width configurations equal the dry run's
  (a dispatch group that straddles the data split:
  tests/test_torch_fallback_sharded.py).

Tolerances are tests/test_torch_lm_sharded.py's: losses at rtol 1e-5, f32
tensors (logits, gradients) at 1e-4 of their largest entry.
"""
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.training.serve import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch.dryrun import lm_cell_bytes  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model import (TransformerLM, embed_tokens, init_params,  # noqa: E402
                                      lm_loss, prefill_step)
from repro_torch.models.moe import switch_aux  # noqa: E402
from repro_torch.models.transformer import forward_train, padded_experts  # noqa: E402
from repro_torch.multihost import spawn_ranks  # noqa: E402
from repro_torch.sharding.placement import (bind_shards, init_shards, shard_model,  # noqa: E402
                                            shard_tensors)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_moe_rank as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_moe_rank.py")
RANK_TIMEOUT = 120.0
F32 = dict(rtol=1e-4, atol=1e-4)
B, S, NEW = 2, 24, 6
TRAIN_B, TRAIN_S = 4, 512
SEEDS = {"qwen-serve": 11, "dbrx-serve": 12, "qwen-2x2": 5, "qwen-1x4": 5, "dbrx-2x2": 6,
         "dbrx-1x4": 6, "padded-1x4": 7, "qwen-layer": 8}
TRAIN = ("qwen-2x2", "qwen-1x4", "dbrx-2x2", "dbrx-1x4", "padded-1x4")


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf, np.float32)
    return out


def _scaled(got, want, rtol, what=""):
    """Every entry within rtol of the largest |entry| of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _tp(name):
    return make_mesh(R.CASES[name][2]).shape["model"]


def _jcfg(name):
    arch, over, _, _ = R.CASES[name]
    return jconfigs.get_config(arch).reduced(**over)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the four ranks' run (in a thread) beside the reference's
    values, and the port's whole models at the same weights."""
    work = str(tmp_path_factory.mktemp("moe_sharded"))
    params = {n: jinit_params(jax.random.key(SEEDS[n]), _jcfg(n), _tp(n)) for n in R.CASES}
    rng = np.random.default_rng(0)
    vocab = _jcfg("qwen-2x2").vocab
    batch = rng.integers(0, vocab, (2, TRAIN_B, TRAIN_S)).astype(np.int32)
    d = _jcfg("qwen-layer").d_model
    inputs = {"batch": batch, "cache_len": S + NEW,
              "qwen-layer/x": rng.standard_normal((2, 1024, d)).astype(np.float32),
              "qwen-layer/cot": rng.standard_normal((2, 1024, d)).astype(np.float32)}
    ref = {}
    for name in ("qwen-serve", "dbrx-serve"):
        jcfg, tp = _jcfg(name), _tp(name)
        prompt = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        logits, cache = jax.jit(make_prefill_step(jcfg, S + NEW, tp=tp))(params[name],
                                                                         jnp.asarray(prompt))
        decode = jax.jit(make_decode_step(jcfg, tp=tp))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        ref[name] = {"prefill_logits": np.asarray(logits), "step_logits": []}
        tokens = []
        for _ in range(NEW - 1):
            tokens.append(np.array(tok))
            tok, logits, cache = decode(params[name], tok, cache)
            ref[name]["step_logits"].append(np.asarray(logits))
        inputs[f"{name}/prompt"], inputs[f"{name}/tokens"] = prompt, np.stack(tokens)
    for name, p in params.items():
        inputs.update(_flat(_np32(p), f"params/{name}"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)

    ranks_out = {}

    def ranks():
        ranks_out["results"] = spawn_ranks([sys.executable, HELPER, work], 4,
                                           timeout_s=RANK_TIMEOUT)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        # The reference's loss and gradient at tp while the ranks run: the
        # 2 x 2 and 1 x 4 cases of one architecture share their weights and
        # their loss (4 experts need no padding at tp 2 or 4).
        tok, lab = batch
        for name in ("qwen-2x2", "dbrx-2x2", "padded-1x4"):
            jcfg, tp = _jcfg(name), _tp(name)
            loss, grads = jax.value_and_grad(
                lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg, tp=tp))(
                params[name])
            ref[name] = {"loss": float(loss), "grads": _np32(grads)}
        ref["qwen-1x4"], ref["dbrx-1x4"] = ref["qwen-2x2"], ref["dbrx-2x2"]
    finally:
        thread.join()
    for r, (code, text) in enumerate(ranks_out["results"]):
        assert code == 0, f"rank {r} exited with {code}:\n{text}"
    out = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(4)]
    whole = {n: convert.lm_params_from_reference(_np32(params[n]), R.case_config(n), tp=_tp(n))
             for n in R.CASES}
    return dict(ref=ref, ranks=out, whole=whole, batch=batch, inputs=inputs)


# -- serving at 1 x 4 --------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen-serve", "dbrx-serve"])
def test_sharded_moe_serving_matches_reference(run, name):
    ref, ranks = run["ref"][name], run["ranks"]
    cfg = R.case_config(name)
    for r, out in enumerate(ranks):
        assert out[f"{name}/experts"] == padded_experts(cfg, 4) // 4
        np.testing.assert_allclose(out[f"{name}/prefill_logits"], ref["prefill_logits"], **F32)
        assert len(out[f"{name}/step_logits"]) == len(ref["step_logits"]) == NEW - 1
        for got, want in zip(out[f"{name}/step_logits"], ref["step_logits"]):
            np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_array_equal(out[f"{name}/step_logits"], ranks[0][f"{name}/step_logits"])


# -- the loss with aux and every gradient leaf -------------------------------------

@pytest.mark.parametrize("name", TRAIN)
def test_sharded_moe_loss_and_gradient_match_the_reference(run, name):
    ref, ranks = run["ref"][name], run["ranks"]
    cfg, tp = R.case_config(name), _tp(name)
    whole = run["whole"][name]
    tok, lab = (torch.from_numpy(a) for a in run["batch"])
    loss = lm_loss(whole, tok, lab, tp=tp)
    grads = torch.autograd.grad(loss, tuple(whole.parameters()))
    for out in ranks:
        np.testing.assert_allclose(out[f"{name}/loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(out[f"{name}/loss"], float(loss.detach()), rtol=1e-5)
        assert out[f"{name}/loss"] == ranks[0][f"{name}/loss"]
    names = convert.param_names(cfg, tp)
    jwant = convert.tensors_from_reference_tree(names, ref["grads"])
    out = ranks[0]
    for pname, g, jg in zip(names, grads, jwant):
        _scaled(out[f"{name}/grad/{pname}"], g.numpy(), 1e-4, pname)
        _scaled(out[f"{name}/grad/{pname}"], np.asarray(jg), 1e-4, pname)
    # The last-token logits of a prefill of the batch, against the whole model.
    with torch.no_grad():
        want = prefill_step(whole, tok, TRAIN_S, tp=tp)[0].numpy()
    rows = TRAIN_B // make_mesh(R.CASES[name][2]).shape["data"]
    for r, out in enumerate(ranks):
        d = make_mesh(R.CASES[name][2]).coords(r)[0]
        np.testing.assert_allclose(out[f"{name}/prefill_logits"], want[d * rows:(d + 1) * rows],
                                   **F32)


def test_padded_experts_get_zero_gradients(run):
    name = "padded-1x4"
    cfg = R.case_config(name)
    e_pad = padded_experts(cfg, 4)
    assert (cfg.n_experts, e_pad) == (6, 8)
    out = run["ranks"][0]
    names = convert.param_names(cfg, 4)
    for pname in names:
        if pname.split(".")[-1] in ("w_gate", "w_up", "w_down") and ".moe.w_" in pname:
            g = out[f"{name}/grad/{pname}"]
            assert g.shape[0] == e_pad and np.abs(g[:cfg.n_experts]).max() > 0
            assert not np.any(g[cfg.n_experts:]), pname
        if pname.endswith(".moe.router"):
            assert not np.any(out[f"{name}/grad/{pname}"][:, cfg.n_experts:]), pname
    # Rank 3 owns experts 6 and 7, both padded: they run on empty slots.
    assert all(o[f"{name}/experts"] == 2 for o in run["ranks"])


def test_aux_at_a_data_split_is_the_global_batch(run):
    """The sharded load-balancing loss at 2 x 2 is the whole batch's (its
    fractions summed over 'data' before their product); the mean of the
    two data ranks' own losses (each from its own fractions) is not."""
    name = "qwen-2x2"
    whole, cfg = run["whole"][name], R.case_config(name)
    tok = torch.from_numpy(run["batch"][0])

    def aux_of(rows):
        with torch.no_grad():
            positions = torch.arange(TRAIN_S, dtype=torch.int32).expand(rows.shape[0], TRAIN_S)
            return float(forward_train(whole.layers, embed_tokens(whole, rows), cfg, positions,
                                       2)[1])

    want = aux_of(tok)
    fault = 0.5 * (aux_of(tok[:2]) + aux_of(tok[2:]))
    for out in run["ranks"]:
        np.testing.assert_allclose(out[f"{name}/aux"], want, rtol=1e-5)
    assert abs(fault - want) > 1e-5 * abs(want) * 10, (fault, want)


def test_router_gradient_counts_the_routers_input_gradient_once(run):
    """Layer 0's MoE at 1 x 4 on a fixed input: the output, and the
    gradients of <out, cot> + aux with respect to the input and the router,
    against the whole layer's, the same on every rank. The router reads the
    input as it is (its input gradient alike on every rank), the dispatch
    reads it through ``to_model``: had the router read it through
    ``to_model`` too, its input gradient would count tp times; that fault
    lies beyond the limit."""
    name = "qwen-layer"
    moe = run["whole"][name].layers[0].moe
    x = torch.from_numpy(run["inputs"][f"{name}/x"]).requires_grad_(True)
    cot = torch.from_numpy(run["inputs"][f"{name}/cot"])

    def grads(route_input):
        r = moe.routing(route_input(x))
        y = moe._combine(x, r, 0, r.gate, (moe.w_gate, moe.w_up, moe.w_down))
        y = y.reshape(x.shape) + moe.shared(x)
        obj = (y * cot).sum() + switch_aux(r, moe.cfg.n_experts, r.expert.shape[-1])
        return y, torch.autograd.grad(obj, (x, moe.router))

    y, (dx, drouter) = grads(lambda t: t)
    _, (dx_disp, _) = grads(lambda t: t.detach())
    dx_router = dx - dx_disp
    fault = dx + 3 * dx_router
    for out in run["ranks"]:
        _scaled(out[f"{name}/out"], y.detach().numpy(), 1e-4, "out")
        _scaled(out[f"{name}/dx"], dx.numpy(), 1e-4, "dx")
        _scaled(out[f"{name}/drouter"], drouter.numpy(), 1e-4, "drouter")
        np.testing.assert_array_equal(out[f"{name}/dx"], run["ranks"][0][f"{name}/dx"])
    err = float(np.abs(fault.numpy() - dx.numpy()).max())
    assert err > 1e-4 * float(dx.abs().max()) * 10, err


# -- without processes ------------------------------------------------------------

@pytest.mark.parametrize("mesh_spec", ["1x4", "2x2"])
@pytest.mark.parametrize("arch,over", [("qwen2-moe-a2.7b", {}), ("dbrx-132b", {}),
                                       ("qwen2-moe-a2.7b", {"n_experts": 6})])
def test_shard_only_initialisation_is_the_whole_weights_cut(arch, over, mesh_spec):
    cfg = tconfigs.get_config(arch).reduced(**over)
    mesh = make_mesh(mesh_spec)
    whole = init_params(cfg, torch.Generator().manual_seed(0), tp=mesh.shape["model"])
    for r in range(mesh.size):
        want = shard_tensors(whole, list(whole.parameters()), mesh, r)
        got = init_shards(cfg, torch.Generator().manual_seed(0), mesh, r, "cpu")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.is_contiguous() and torch.equal(a, b)


@pytest.mark.parametrize("mesh_spec", ["1x4", "2x2"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_full_width_shards_match_the_dry_run(arch, mesh_spec):
    """Every rank of the full-width configuration (on ``meta``) holds
    E_p / tp experts a layer and the bytes ``lm_cell_bytes`` reckons for
    it, for serving and for training (params, grads and Adam moments)."""
    cfg = tconfigs.get_config(arch)
    mesh = make_mesh(mesh_spec)
    tp = mesh.shape["model"]
    whole = TransformerLM(cfg, device="meta", tp=tp)
    serve = lm_cell_bytes(cfg, ShapeSpec("t", 4096, 4, "decode"), mesh)
    train = lm_cell_bytes(cfg, ShapeSpec("t", 2048, 4, "train"), mesh)
    for r in range(mesh.size):
        model = shard_model(whole, mesh, r)
        assert model.layers[0].moe.w_gate.shape[0] == padded_experts(cfg, tp) // tp
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        f32 = sum(p.numel() * 4 for p in model.parameters())
        assert nbytes == serve["param_bytes"] == train["param_bytes"]
        assert 2 * nbytes + 2 * f32 == train["adam_state_bytes"]
    assert padded_experts(tconfigs.get_config("qwen2-moe-a2.7b"), 4) // 4 == 15
