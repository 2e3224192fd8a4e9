"""The recurrent stacks (zamba2's mamba2 groups with their shared attention
block, and rwkv6) split over a D x M mesh of rank processes in the
reference's ``FULL_BATCH`` scan layout, against the JAX package and the
port's whole-tensor runs, on the CPU.

Four gloo ranks (tests/_torch_recurrent_rank.py, each spawned with its own
timeout) run every case of its ``CASES`` on the reference's
``init_params`` weights (every leaf that it initialises to a constant
perturbed, so that a norm, decay or bonus read at the wrong channels
shows) carried across with ``convert.lm_params_from_reference``, while this
process computes the reference's values:

* serving at 1 x 4 (4 rows: one a rank in the scans): prefill and
  teacher-forced decode logits against the reference's ``serve_step``, and
  the prefilled cache, reassembled from the ranks' blocks, against the
  whole model's (the handoff from the scan's rows to the cache's heads);
* the loss and every gathered gradient leaf at 2 x 2 and 1 x 4 against
  ``jax.value_and_grad`` of the reference's ``lm_loss``, and the prefill's
  last-token logits against the whole model's; the same on 2 rows at 1 x 4,
  where ``FULL_BATCH`` resolves to no split over 'model' and the scan is
  replicated over it (``constraints._resolve``'s prefix);
* the planted faults: the region's replicated leaves' gradients summed over
  'model' once too few or once too often lie beyond the limit;
* the all-to-all: its blocks, the round trip and the backward, bitwise.

Without processes: the column shards are whole heads, the shard-only
initialisation is bitwise the whole weights cut, and the full-width
configurations' shard bytes equal the dry run's.

Tolerances are tests/test_torch_lm_sharded.py's: losses at rtol 1e-5, f32
tensors (logits, gradients, caches) at 1e-4 of their largest entry, but
zamba2's gradients at 2.5e-4 (its f32 gradient floor: the ROADMAP tolerance
note, tests/test_torch_training.py's ``GRAD_RTOL``).
"""
import ast
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
from repro_torch.models.model import (TransformerLM, init_params, lm_loss,  # noqa: E402
                                      prefill_step)
from repro_torch.multihost import spawn_ranks  # noqa: E402
from repro_torch.sharding.placement import (assemble, init_shards,  # noqa: E402
                                            local_shard, parameter_specs,
                                            shard_model, shard_tensors)
from repro_torch.sharding.rules import cache_specs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_recurrent_rank as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_recurrent_rank.py")
RANK_TIMEOUT = 120.0
F32 = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = {"zamba2-2.7b": 2.5e-4, "rwkv6-3b": 1e-4}
# Serving: 150 tokens are two SSD chunks (the last ragged) and ten WKV
# chunks; training at 64 tokens (the reference's mamba2 gradient is NaN
# from 128 on: ROADMAP fault 9).
B, S, NEW = 4, 150, 6
TRAIN_B, TRAIN_S = 4, 64
SEEDS = {"zamba2-2.7b": 3, "rwkv6-3b": 4}
TRAIN = ("zamba2-2x2", "zamba2-1x4", "rwkv6-2x2", "rwkv6-1x4", "zamba2-rows2", "rwkv6-rows2")
# The replicated leaves whose planted faults are read, one a stack.
FAULT_LEAF = {"zamba2-2.7b": "layers.0.mamba.A_log", "rwkv6-3b": "layers.0.rwkv.u_bonus"}


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf, np.float32)
    return out


def _perturbed(params, seed: int):
    """The reference's weights with every leaf that ``init_params`` fills
    with one value (norms, ``A_log``, ``dt_bias``, ``D_skip``, ``w_base``,
    ``u_bonus``, ``mu``, ...) moved by 0.1 standard normal draws: larger
    moves leave the reduced zamba2's f32 gradient worse conditioned, so
    that the whole port model itself comes near the 2.5e-4 limit."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray(a)

    return jax.tree.map(one, params)


def _scaled_err(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) or 1.0)


def _jcfg(arch):
    return jconfigs.get_config(arch).reduced(dtype="float32")


def _summary(out, name) -> dict:
    return ast.literal_eval(str(out[f"{name}/collectives"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the four ranks' run (in a thread) beside the reference's
    values, and the port's whole models at the same weights."""
    work = str(tmp_path_factory.mktemp("recurrent_sharded"))
    params = {a: _perturbed(jinit_params(jax.random.key(SEEDS[a]), _jcfg(a)), SEEDS[a])
              for a in R.ARCHS}
    rng = np.random.default_rng(0)
    vocab = _jcfg("rwkv6-3b").vocab
    batch = rng.integers(0, vocab, (2, TRAIN_B, TRAIN_S)).astype(np.int32)
    inputs = {"batch": batch, "cache_len": S + NEW}
    ref = {}
    for arch in R.ARCHS:
        jcfg = _jcfg(arch)
        prompt = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        logits, cache = jax.jit(make_prefill_step(jcfg, S + NEW, tp=4))(params[arch],
                                                                        jnp.asarray(prompt))
        decode = jax.jit(make_decode_step(jcfg, tp=4))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        ref[f"{arch}-serve"] = {"prefill_logits": np.asarray(logits), "step_logits": []}
        tokens = []
        for _ in range(NEW - 1):
            tokens.append(np.array(tok))
            tok, logits, cache = decode(params[arch], tok, cache)
            ref[f"{arch}-serve"]["step_logits"].append(np.asarray(logits))
        inputs[f"{arch}/prompt"], inputs[f"{arch}/tokens"] = prompt, np.stack(tokens)
        inputs.update(_flat(_np32(params[arch]), f"params/{arch}"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)

    ranks_out = {}

    def ranks():
        ranks_out["results"] = spawn_ranks([sys.executable, HELPER, work], 4,
                                           timeout_s=RANK_TIMEOUT)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        # The reference's loss and gradient while the ranks run: on 4 rows
        # (the 2 x 2, 1 x 4 and planted-fault cases) and on 2.
        tok, lab = batch
        for arch in R.ARCHS:
            jcfg = _jcfg(arch)
            for rows in (4, 2):
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p: jlm_loss(p, jnp.asarray(tok[:rows]), jnp.asarray(lab[:rows]),
                                       jcfg)))(params[arch])
                ref[f"{arch}/{rows}"] = {"loss": float(loss), "grads": _np32(grads)}
    finally:
        thread.join()
    for r, (code, text) in enumerate(ranks_out["results"]):
        assert code == 0, f"rank {r} exited with {code}:\n{text}"
    out = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(4)]
    whole = {a: convert.lm_params_from_reference(_np32(params[a]), R.arch_config(a), tp=4)
             for a in R.ARCHS}
    return dict(ref=ref, ranks=out, whole=whole, batch=batch, inputs=inputs)


# -- serving at 1 x 4 --------------------------------------------------------------

@pytest.mark.parametrize("arch", R.ARCHS)
def test_sharded_recurrent_serving_matches_reference(run, arch):
    name = f"{arch.split('-')[0]}-serve"
    ref, ranks = run["ref"][f"{arch}-serve"], run["ranks"]
    for out in ranks:
        np.testing.assert_allclose(out[f"{name}/prefill_logits"], ref["prefill_logits"], **F32)
        assert len(out[f"{name}/step_logits"]) == len(ref["step_logits"]) == NEW - 1
        for got, want in zip(out[f"{name}/step_logits"], ref["step_logits"]):
            np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_array_equal(out[f"{name}/step_logits"], ranks[0][f"{name}/step_logits"])
    # The prefill's scans ran with their rows over 'model': their inputs and
    # results passed the all-to-all, counted under the stack's tag.
    tag = "all_to_all:ssd" if arch.startswith("zamba2") else "all_to_all:wkv"
    assert _summary(ranks[0], name)["model"][tag]["calls"] > 0


@pytest.mark.parametrize("arch", R.ARCHS)
def test_prefilled_cache_reassembled_is_the_whole_models(run, arch):
    """The handoff: each rank's prefilled cache (the scans' final states
    returned from rows over 'model' to heads over 'model', the conv tails'
    and last tokens' blocks, the shared block's KV heads), reassembled by
    ``cache_specs``, against the whole model's prefill of the same prompt."""
    name = f"{arch.split('-')[0]}-serve"
    whole = run["whole"][arch]
    prompt = torch.from_numpy(run["inputs"][f"{arch}/prompt"])
    with torch.inference_mode():
        _, cache = prefill_step(whole, prompt, S + NEW)
    specs = cache_specs(cache, make_mesh("1x4"))
    leaves = [k for k, v in cache.items() if torch.is_tensor(v)]
    assert set(leaves) == ({"ssd", "conv", "k", "v"} if arch.startswith("zamba2")
                           else {"wkv", "last1", "last2"})
    for k in leaves:
        assert "model" in specs[k], (k, specs[k])
        got = assemble([torch.from_numpy(out[f"{name}/cache/{k}"]) for out in run["ranks"]],
                       specs[k], make_mesh("1x4"))
        assert _scaled_err(got.numpy(), cache[k].numpy()) <= 1e-4, k


# -- the loss and every gradient leaf ----------------------------------------------

@pytest.mark.parametrize("name", TRAIN)
def test_sharded_recurrent_loss_and_gradient_match_the_reference(run, name):
    arch, mesh_spec, _, rows = R.CASES[name]
    ref, ranks = run["ref"][f"{arch}/{rows}"], run["ranks"]
    cfg = R.arch_config(arch)
    for out in ranks:
        np.testing.assert_allclose(out[f"{name}/loss"], ref["loss"], rtol=1e-5)
        assert out[f"{name}/loss"] == ranks[0][f"{name}/loss"]
    names = convert.param_names(cfg)
    jwant = convert.tensors_from_reference_tree(names, ref["grads"])
    for pname, jg in zip(names, jwant):
        err = _scaled_err(ranks[0][f"{name}/grad/{pname}"], np.asarray(jg))
        assert err <= GRAD_RTOL[arch], (pname, err)
    # The last-token logits of a prefill of the rows, against the whole model.
    mesh = make_mesh(mesh_spec)
    whole = run["whole"][arch]
    tok = torch.from_numpy(run["batch"][0][:rows])
    with torch.no_grad():
        want = prefill_step(whole, tok, TRAIN_S)[0].numpy()
    per = rows // mesh.shape["data"]
    for r, out in enumerate(ranks):
        d = mesh.coords(r)[0]
        np.testing.assert_allclose(out[f"{name}/prefill_logits"], want[d * per:(d + 1) * per],
                                   **F32)
    # Rows over every axis exchange the scans' inputs over 'model'; 2 rows
    # at 1 x 4 do not divide over it, and the scan is replicated instead.
    tag = "all_to_all:ssd" if arch.startswith("zamba2") else "all_to_all:wkv"
    model_ops = _summary(ranks[0], name)["model"]
    if rows == 2:
        assert tag not in model_ops or model_ops[tag]["calls"] == 0
        assert model_ops["all_gather"]["calls"] > 0
    else:
        assert model_ops[tag]["calls"] > 0


@pytest.mark.parametrize("arch", R.ARCHS)
def test_planted_replicated_leaf_faults_lie_beyond_the_limit(run, arch):
    """The leaves read in the FULL_BATCH region get only their rows' part of
    the gradient on a rank: summed over 'model' once (the run) they match
    the reference; not summed (``few``) or summed twice (``often``) they
    lie beyond the limit."""
    short = arch.split("-")[0]
    ref = run["ref"][f"{arch}/4"]
    cfg = R.arch_config(arch)
    names = convert.param_names(cfg)
    jwant = dict(zip(names, convert.tensors_from_reference_tree(names, ref["grads"])))
    leaf = FAULT_LEAF[arch]
    good = _scaled_err(run["ranks"][0][f"{short}-1x4/grad/{leaf}"], jwant[leaf])
    assert good <= GRAD_RTOL[arch]
    for kind in ("few", "often"):
        err = _scaled_err(run["ranks"][0][f"{short}-{kind}/grad/{leaf}"], jwant[leaf])
        assert err > 10 * GRAD_RTOL[arch], (kind, err)


def test_all_to_all_blocks_round_trip_and_backward_are_bitwise(run):
    """Rank m's output holds row block m of every rank's input, the ranks'
    head blocks in coordinate order; the inverse all-to-all returns the
    input bitwise (f32 and bf16), and the gradient is the inverse all-to-all
    of the cotangent, bitwise."""
    ranks = run["ranks"]
    xs = [R.exchange_input(r).numpy() for r in range(4)]
    n = R.EXCHANGE_SHAPE[0] // 4
    for m, out in enumerate(ranks):
        want = np.concatenate([x[m * n:(m + 1) * n] for x in xs], axis=2)
        np.testing.assert_array_equal(out["exchange/out"], want)
        assert out["exchange/round_trip_equal"] and out["exchange/bf16_round_trip_equal"]
        assert out["exchange/grad_is_inverse"]
        calls = _summary(out, "exchange")["model"]["all_to_all:test"]
        assert calls["calls"] == 3 and calls["bytes"] > 0   # forward, round trip, backward


# -- without processes ------------------------------------------------------------

@pytest.mark.parametrize("mesh_spec", ["1x4", "2x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_column_shards_are_whole_heads(arch, mesh_spec):
    """At full width, every rank's columns of the column-parallel leaves
    (and the decay LoRA's and conv taps' channels, the row-parallel ``wo``'s
    rows) are whole heads, contiguous, in the head-major (H, P) / (H, K)
    channel order the layers read: a leaf whose channel c carries its head
    c // P cut to the rank holds heads [m H / tp, (m + 1) H / tp), each
    complete."""
    cfg = tconfigs.get_config(arch)
    mesh = make_mesh(mesh_spec)
    tp = mesh.shape["model"]
    model = TransformerLM(cfg, device="meta")
    specs = parameter_specs(model, mesh)
    if cfg.block_kind == "mamba2":
        heads, width = cfg.ssm_heads, cfg.ssm_head_dim
        leaves = {"wz": 1, "wx": 1, "conv_w": 1, "wo": 0}
        prefix = "layers.0.mamba."
    else:
        heads, width = cfg.n_heads, cfg.head_dim
        leaves = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "w_lora_b": 1, "wo": 0}
        prefix = "layers.0.rwkv."
    for leaf, dim in leaves.items():
        name = prefix + leaf
        shape = tuple(dict(model.named_parameters())[name].shape)
        assert shape[dim] == heads * width, name
        head_of = torch.arange(heads * width) // width
        whole = head_of.reshape([-1 if d == dim else 1 for d in range(2)]).expand(shape)
        for r in range(mesh.size):
            m = mesh.coords(r)[1]
            got = local_shard(whole, specs[name], mesh, mesh.coords(r)).select(1 - dim, 0)
            want = torch.arange(m * heads // tp, (m + 1) * heads // tp).repeat_interleave(width)
            assert torch.equal(got, want), (name, r)


@pytest.mark.parametrize("mesh_spec", ["1x4", "2x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_shard_only_initialisation_is_the_whole_weights_cut(arch, mesh_spec):
    cfg = tconfigs.get_config(arch).reduced()
    mesh = make_mesh(mesh_spec)
    whole = init_params(cfg, torch.Generator().manual_seed(0))
    for r in range(mesh.size):
        want = shard_tensors(whole, list(whole.parameters()), mesh, r)
        got = init_shards(cfg, torch.Generator().manual_seed(0), mesh, r, "cpu")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.is_contiguous() and torch.equal(a, b)


@pytest.mark.parametrize("mesh_spec", ["1x4", "2x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_full_width_shards_match_the_dry_run(arch, mesh_spec):
    """Every rank of the full-width configuration (on ``meta``) holds the
    bytes ``lm_cell_bytes`` reckons for it: params for serving and training,
    params, grads and Adam moments, and the decode cache of 4 x 4096 + 32
    (``init_cache`` at this rank's blocks)."""
    from repro_torch.models.model import make_empty_cache

    cfg = tconfigs.get_config(arch)
    mesh = make_mesh(mesh_spec)
    whole = TransformerLM(cfg, device="meta")
    serve = lm_cell_bytes(cfg, ShapeSpec("t", 4128, 4, "decode"), mesh)
    train = lm_cell_bytes(cfg, ShapeSpec("t", 2048, 4, "train"), mesh)
    for r in range(mesh.size):
        model = shard_model(whole, mesh, r)
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        f32 = sum(p.numel() * 4 for p in model.parameters())
        assert nbytes == serve["param_bytes"] == train["param_bytes"]
        assert 2 * nbytes + 2 * f32 == train["adam_state_bytes"]
        cache = make_empty_cache(model, 4, 4128, tp=mesh.shape["model"])
        assert sum(v.numel() * v.element_size() for v in cache.values()
                   if torch.is_tensor(v)) == serve["cache_bytes"]
