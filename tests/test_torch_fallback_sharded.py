"""The sharding rules' fallbacks on a D x M mesh of rank processes, against
the JAX package and the port's whole-tensor runs, on the CPU.

The reference's rules replicate a leaf where the model axis does not divide
its dimension (``rules._fit``) and split the decode cache's sequence where
it does not divide the cache's heads (``rules.cache_specs``); its MoE
groups tokens in (b, s) order over the global batch. Four gloo ranks
(tests/_torch_fallback_rank.py, each spawned with its own timeout) run every
case of its ``CASES`` on the reference's ``init_params`` weights (every
leaf it initialises to a constant perturbed) carried across with
``convert.lm_params_from_reference``, while this process computes the
reference's values:

* (a) reduced qwen2-moe at 2 x 2 whose dispatch groups straddle the data
  split (1 x 256 tokens a rank against a group of 512 in the prefill, one
  token a rank against a group of 2 at decode; capacity 1.0, so that the
  group's slots bind): prefill and teacher-forced decode logits against the
  reference's ``serve_step``; the loss and every gathered gradient leaf
  against ``jax.value_and_grad`` of its ``lm_loss``; layer 0's MoE alone
  at 256 and 1536 tokens a rank (the latter one whole group of 1024 and
  half of the next), its routing (expert, slot, keep) bitwise the whole
  layer's and its output, input and router gradients against the whole
  layer's;
* (b) at 1 x 4, configurations whose heads the model axis does not divide:
  attention with 6 query and 2 KV heads of 16 (24 columns a rank = 1.5
  heads), rwkv6 with 6 heads (48 channels a rank), zamba2 with 6 SSD heads
  (48 channels a rank), and rwkv6 with d_ff 258 (its channel mix's hidden
  features replicated over 'model'): prefill, teacher-forced decode, the
  loss and every gradient leaf against the reference;
* (c) the attention configuration's decode cache split over its sequence
  (32 slots, 8 a rank: the rows' max and sums over 'model') and whole on
  every rank (31 slots): the logits, and each rank's cache block after the
  last step reassembled by ``cache_specs`` against the reference's cache;
* the same for blocks whose every leaf the rules replicate over 'model'
  (then run whole on every rank): attention with 5 heads of 14, d_ff 258
  and a vocabulary of 258, zamba2 with d_inner 198, rwkv6 with H K 150.

Without processes: every new case's shard bytes (and the full-width
minitron-4b and rwkv6-3b at 1 x 16, qwen2-moe at 2 x 2) equal the dry
run's; the full-width configurations that used to be refused now shard;
``serve lm --mesh 2x2 --sharded`` on reduced qwen2-moe gives the greedy
tokens of ``--mesh 1x1``.

Tolerances are the sharded tests': losses at rtol 1e-5, f32 tensors
(logits, gradients, caches) at 1e-4 of their largest entry, zamba2's
gradients at 2.5e-4 (its f32 gradient floor: tests/test_torch_training.py's
``GRAD_RTOL``).
"""
import ast
import os
import re
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
from repro_torch.models.attention import cache_block, cache_heads_local  # noqa: E402
from repro_torch.models.model import TransformerLM, make_empty_cache  # noqa: E402
from repro_torch.multihost import spawn_ranks  # noqa: E402
from repro_torch.sharding.placement import (assemble, check_shardable,  # noqa: E402
                                            parameter_specs, shard_model)
from repro_torch.sharding.rules import cache_specs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fallback_rank as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_fallback_rank.py")
RANK_TIMEOUT = 120.0
SEEDS = {"moe": 21, "attn": 22, "rwkv6": 23, "zamba2": 24, "ff258": 25, "attn-rep": 26,
         "zamba2-rep": 27, "rwkv6-rep": 28}
# Serving rows (the recurrent stacks' 4: one a rank in the FULL_BATCH scans)
# and training batches (rows, tokens; qwen2-moe's 256 tokens a rank at 2 x 2
# against a group of 512; the recurrent stacks below 128 tokens, where the
# reference's mamba2 gradient is NaN: ROADMAP fault 9).
SERVE_ROWS = {"moe": 2, "attn": 2, "rwkv6": 4, "zamba2": 4, "ff258": 4, "attn-rep": 2,
              "zamba2-rep": 4, "rwkv6-rep": 4}
TRAIN_SHAPE = {"moe": (2, 256), "attn": (2, 32), "rwkv6": (4, 32), "zamba2": (4, 32),
               "ff258": (4, 32), "attn-rep": (2, 32), "zamba2-rep": (4, 32), "rwkv6-rep": (4, 32)}
GRAD_RTOL = {"zamba2": 2.5e-4, "zamba2-rep": 2.5e-4}
# Layer 0's MoE alone at 2 x 2, one row a data rank: 256 tokens a rank (one
# group of 512 over both), and 1536 (groups of 1024: rank 0 holds group 0
# and half of group 1, rank 1 the other half and group 2).
LAYER_SHAPE = {"moe-layer": (2, 256), "moe-wide": (2, 1536)}
SERVE = [n for n, c in R.CASES.items() if c[1] == "serve"]
TRAIN = [n for n, c in R.CASES.items() if c[1] == "train"]


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf, np.float32)
    return out


def _perturbed(params, seed: int):
    """The reference's weights with every leaf that ``init_params`` fills
    with one value (norms, ``A_log``, ``u_bonus``, ``mu``, ...) moved by 0.1
    standard normal draws, so that one read at the wrong channels shows."""
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
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) or 1.0)


def _jcfg(cname):
    arch, over, _ = R.CONFIGS[cname]
    return jconfigs.get_config(arch).reduced(dtype="float32", **over)


def _mesh(cname):
    return make_mesh(R.CONFIGS[cname][2])


def _summary(out, name) -> dict:
    return ast.literal_eval(str(out[f"{name}/collectives"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the four ranks' run (in a thread) beside the reference's
    values, and the port's whole models at the same weights."""
    work = str(tmp_path_factory.mktemp("fallback_sharded"))
    params = {c: _perturbed(jinit_params(jax.random.key(SEEDS[c]), _jcfg(c), R.tp_of(c)),
                            SEEDS[c]) for c in R.CONFIGS}
    rng = np.random.default_rng(0)
    inputs, ref = {}, {}
    for name, (cname, kind, length) in R.CASES.items():
        jcfg, tp = _jcfg(cname), R.tp_of(cname)
        if kind == "serve":
            prompt = rng.integers(0, jcfg.vocab, (SERVE_ROWS[cname], length - R.NEW)).astype(
                np.int32)
            logits, cache = jax.jit(make_prefill_step(jcfg, length, tp=tp))(params[cname],
                                                                            jnp.asarray(prompt))
            decode = jax.jit(make_decode_step(jcfg, tp=tp))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
            ref[name] = {"prefill_logits": np.asarray(logits), "step_logits": []}
            tokens = []
            for _ in range(R.NEW - 1):
                tokens.append(np.array(tok))
                tok, logits, cache = decode(params[cname], tok, cache)
                ref[name]["step_logits"].append(np.asarray(logits))
            ref[name]["cache"] = {k: np.asarray(v, np.float32) for k, v in cache.items()
                                  if np.ndim(v)}
            inputs.update({f"{name}/prompt": prompt, f"{name}/tokens": np.stack(tokens),
                           f"{name}/len": length})
        elif kind == "train":
            inputs[f"{name}/batch"] = rng.integers(
                0, jcfg.vocab, (2,) + TRAIN_SHAPE[cname]).astype(np.int32)
        else:
            shape = LAYER_SHAPE[name] + (jcfg.d_model,)
            inputs[f"{name}/x"] = rng.standard_normal(shape).astype(np.float32)
            inputs[f"{name}/cot"] = rng.standard_normal(shape).astype(np.float32)
    for cname, p in params.items():
        inputs.update(_flat(_np32(p), f"params/{cname}"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)

    ranks_out = {}

    def ranks():
        ranks_out["results"] = spawn_ranks([sys.executable, HELPER, work], 4,
                                           timeout_s=RANK_TIMEOUT)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        # The reference's loss and gradient while the ranks run.
        for name in TRAIN:
            cname = R.CASES[name][0]
            jcfg, tp = _jcfg(cname), R.tp_of(cname)
            tok, lab = (jnp.asarray(a) for a in inputs[f"{name}/batch"])
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jlm_loss(p, tok, lab, jcfg, tp=tp)))(params[cname])
            ref[name] = {"loss": float(loss), "grads": _np32(grads)}
    finally:
        thread.join()
    for r, (code, text) in enumerate(ranks_out["results"]):
        assert code == 0, f"rank {r} exited with {code}:\n{text}"
    out = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(4)]
    whole = {c: convert.lm_params_from_reference(_np32(params[c]), R.config(c), tp=R.tp_of(c))
             for c in R.CONFIGS}
    return dict(ref=ref, ranks=out, whole=whole, inputs=inputs)


# -- serving: prefill, decode and the cache ----------------------------------------

@pytest.mark.parametrize("name", SERVE)
def test_fallback_serving_matches_reference(run, name):
    """Prefill and teacher-forced decode logits within 1e-4 of the largest
    logit of the reference's, the same bytes on every rank of a row."""
    ref, ranks = run["ref"][name], run["ranks"]
    mesh = _mesh(R.CASES[name][0])
    per = ref["prefill_logits"].shape[0] // mesh.shape["data"]
    for r, out in enumerate(ranks):
        rows = slice(mesh.coords(r)[0] * per, (mesh.coords(r)[0] + 1) * per)
        assert _scaled_err(out[f"{name}/prefill_logits"], ref["prefill_logits"][rows]) <= 1e-4
        assert len(out[f"{name}/step_logits"]) == len(ref["step_logits"]) == R.NEW - 1
        for got, want in zip(out[f"{name}/step_logits"], ref["step_logits"]):
            assert _scaled_err(got, want[rows]) <= 1e-4
        peer = mesh.rank((mesh.coords(r)[0], 0))
        np.testing.assert_array_equal(out[f"{name}/step_logits"],
                                      ranks[peer][f"{name}/step_logits"])


@pytest.mark.parametrize("name", SERVE)
def test_fallback_cache_blocks_match_reference(run, name):
    """Each rank's cache after the last decode step, reassembled by
    ``cache_specs``, against the reference's cache: the attention's split
    over the sequence (32 slots) or whole (31 slots), the recurrent states
    whole where the model axis does not divide their heads."""
    ref, ranks = run["ref"][name]["cache"], run["ranks"]
    mesh = _mesh(R.CASES[name][0])
    specs = cache_specs(ref, mesh)
    assert set(ref) == {k[len(f"{name}/cache/"):] for k in ranks[0]
                        if k.startswith(f"{name}/cache/")}
    for key, want in ref.items():
        got = assemble([torch.from_numpy(out[f"{name}/cache/{key}"]) for out in ranks],
                       specs[key], mesh)
        assert _scaled_err(got.numpy(), want) <= 1e-4, key
    if name == "attn-seq":
        assert specs["k"][2:] == ("model", None, None)
        assert ranks[0][f"{name}/cache/k"].shape[2] == 32 // 4
    if name == "attn-whole":
        assert "model" not in specs["k"] and ranks[0][f"{name}/cache/k"].shape[2] == 31
    if name in ("rwkv6-serve", "zamba2-serve"):
        key = "wkv" if name.startswith("rwkv6") else "ssd"
        assert "model" not in specs[key]          # 6 heads: whole on every rank


def test_sequence_split_decode_sums_over_the_model_axis(run):
    """The sequence-split decode reads each row's max (an all-gather) and
    its sums and P . V partials (``all_reduce:decode``) over 'model'; the
    whole cache's decode needs neither."""
    seq, whole = _summary(run["ranks"][0], "attn-seq"), _summary(run["ranks"][0], "attn-whole")
    layers = R.config("attn").n_layers
    assert seq["model"]["all_reduce:decode"]["calls"] == 2 * layers * (R.NEW - 1)
    assert whole["model"].get("all_reduce:decode", {"calls": 0})["calls"] == 0


# -- the MoE group that straddles the data split -----------------------------------

@pytest.mark.parametrize("name", sorted(LAYER_SHAPE))
def test_straddling_group_routing_is_bitwise_the_whole_layers(run, name):
    """Layer 0's MoE on a fixed input (one row a data rank, ``LAYER_SHAPE``):
    each rank's routing of its tokens (expert, slot, keep) bitwise the whole
    layer's on the global input, some assignments dropped at capacity (so
    rank 1's slots count rank 0's tokens); its output, aux and gradients
    with respect to its rows of the input and the router within 1e-4."""
    whole = run["whole"]["moe"].layers[0].moe
    x = torch.from_numpy(run["inputs"][f"{name}/x"]).requires_grad_(True)
    cot = torch.from_numpy(run["inputs"][f"{name}/cot"])
    y, aux = whole(x)
    dx, drouter = torch.autograd.grad((y * cot).sum() + aux, (x, whole.router))
    with torch.no_grad():
        r = whole.routing(x)
    mesh = _mesh("moe")
    t = x.shape[1]
    assert r.expert.shape[:2] == {256: (1, 512), 1536: (3, 1024)}[t]
    assert not bool(r.keep.all())                          # capacity binds
    for rank, out in enumerate(run["ranks"]):
        d = mesh.coords(rank)[0]
        for f in ("expert", "slot", "keep"):
            flat = getattr(r, f).reshape(-1, r.expert.shape[-1])
            np.testing.assert_array_equal(out[f"{name}/routing/{f}"],
                                          flat[d * t:(d + 1) * t].numpy())
        assert _scaled_err(out[f"{name}/out"], y.detach()[d:d + 1].numpy()) <= 1e-4
        assert _scaled_err(out[f"{name}/dx"], dx[d:d + 1].numpy()) <= 1e-4
        # The router's rows over 'data' (FSDP): the rank's block of the gradient.
        n = drouter.shape[0] // mesh.shape["data"]
        assert _scaled_err(out[f"{name}/drouter"], drouter[d * n:(d + 1) * n].numpy()) <= 1e-4
        np.testing.assert_allclose(out[f"{name}/aux"], float(aux.detach()), rtol=1e-5)
        # The router logits gathered over 'data' (one all-gather a call).
        assert _summary(out, name)["data"]["all_gather"]["calls"] >= 1


# -- the loss and every gradient leaf ----------------------------------------------

@pytest.mark.parametrize("name", TRAIN)
def test_fallback_loss_and_gradient_match_the_reference(run, name):
    cname = R.CASES[name][0]
    ref, ranks = run["ref"][name], run["ranks"]
    cfg, tp = R.config(cname), R.tp_of(cname)
    for out in ranks:
        np.testing.assert_allclose(out[f"{name}/loss"], ref["loss"], rtol=1e-5)
        assert out[f"{name}/loss"] == ranks[0][f"{name}/loss"]
    names = convert.param_names(cfg, tp)
    jwant = convert.tensors_from_reference_tree(names, ref["grads"])
    for pname, jg in zip(names, jwant):
        err = _scaled_err(ranks[0][f"{name}/grad/{pname}"], np.asarray(jg))
        assert err <= GRAD_RTOL.get(cname, 1e-4), (pname, err)


def test_device_exchange_rounds_match_gloo(run):
    """``DeviceExchange``'s protocol (a write, a barrier on the shared
    counts, reads from the peers, a second barrier; several rounds where a
    tensor passes its buffer) over shared files on the CPU: every all-gather
    and all-to-all at 2 x 2 (both axes) and 1 x 4 bitwise gloo's, and every
    rank's count of barriers on each axis the same; then, after one pair of
    the 2 x 2 mesh has passed a round on 'model' alone, a 1 x 4 mesh's
    ``MeshComm`` puts every rank's counts in step and its rounds are gloo's."""
    ranks = run["ranks"]
    keys = [k for k in ranks[0] if k.startswith("exchange/") and k != "exchange/barriers"]
    assert len(keys) == 2 * 3 * 3                       # 3 axis groups x 3 sizes x 2 ops
    for out in ranks:
        assert all(bool(out[k]) for k in keys), [k for k in keys if not out[k]]
        np.testing.assert_array_equal(out["exchange/barriers"], ranks[0]["exchange/barriers"])
    # data and model: 2 rounds a call below 4 KiB, more above
    assert ranks[0]["exchange/barriers"][1] > 0 and ranks[0]["exchange/barriers"][2] > 0
    for out in ranks:
        np.testing.assert_array_equal(out["realign/barriers"], ranks[0]["realign/barriers"])
        assert bool(out["realign/gather"])
    assert ranks[0]["realign/barriers"][2] == ranks[0]["exchange/barriers"][2] + 2


# -- without processes ------------------------------------------------------------

def _shard_bytes_hold(cfg, mesh, cache_len: int, batch: int, tp: int) -> None:
    whole = TransformerLM(cfg, device="meta", tp=tp)
    serve = lm_cell_bytes(cfg, ShapeSpec("t", cache_len, batch, "decode"), mesh)
    train = lm_cell_bytes(cfg, ShapeSpec("t", cache_len, batch, "train"), mesh)
    for r in range(mesh.size):
        model = shard_model(whole, mesh, r)
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        f32 = sum(p.numel() * 4 for p in model.parameters())
        assert nbytes == serve["param_bytes"] == train["param_bytes"]
        assert 2 * nbytes + 2 * f32 == train["adam_state_bytes"]
        cache = make_empty_cache(model, batch, cache_len, tp=tp)
        assert sum(v.numel() * v.element_size() for v in cache.values()
                   if torch.is_tensor(v)) == serve["cache_bytes"]


@pytest.mark.parametrize("cache_len", [32, 31])
@pytest.mark.parametrize("cname", sorted(R.CONFIGS))
def test_new_cases_shard_bytes_match_the_dry_run(cname, cache_len):
    """Every rank of every new case holds the bytes ``lm_cell_bytes``
    reckons: params for serving and training, params, grads and Adam
    moments, and the decode cache at a length the model axis divides and
    one it does not."""
    mesh = _mesh(cname)
    _shard_bytes_hold(R.config(cname), mesh, cache_len, 4, mesh.shape["model"])


@pytest.mark.parametrize("arch,mesh_spec", [("minitron-4b", "1x16"), ("rwkv6-3b", "1x16"),
                                            ("qwen2-moe-a2.7b", "2x2")])
def test_full_width_fallback_shards_match_the_dry_run(arch, mesh_spec):
    """The card's fallback cells on ``meta``: minitron-4b (24 query heads,
    1.5 a rank; 8 cache heads, the sequence split over 16) and rwkv6-3b (40
    heads, 2.5 a rank) at 1 x 16, qwen2-moe at 2 x 2, at 4 x 4128."""
    cfg = tconfigs.get_config(arch)
    mesh = make_mesh(mesh_spec)
    check_shardable(cfg, mesh)
    _shard_bytes_hold(cfg, mesh, 4128, 4, mesh.shape["model"])


def test_refused_full_width_configurations_now_shard():
    """minitron-4b and rwkv6-3b at a model axis of 16 (the reference's
    production width): the column-parallel leaves split by features, not
    heads; minitron's 8 cache heads (r = 1) stay whole, its sequence split."""
    mesh = make_mesh("1x16")
    mini, rwkv = tconfigs.get_config("minitron-4b"), tconfigs.get_config("rwkv6-3b")
    for cfg in (mini, rwkv):
        check_shardable(cfg, mesh)
    assert cache_heads_local(mini, 1, 16) == 8
    assert cache_block(mini, 1, 16, 3, 4128) == (3 * 258, 258, 0, 8)
    assert cache_block(mini, 1, 16, 3, 4127) == (0, 4127, 0, 8)
    specs = parameter_specs(TransformerLM(mini, device="meta"), mesh)
    assert specs["layers.0.attn.wq"][1] == "model" and 3072 // 16 == 192
    specs = parameter_specs(TransformerLM(rwkv, device="meta"), mesh)
    assert specs["layers.0.rwkv.wr"][1] == "model" and 2560 // 16 == 160


@pytest.mark.parametrize("rank", range(4))
def test_split_heads_cover_each_ranks_columns(rank):
    """At 1 x 4 with 6 heads of 16, a rank's ``wq`` columns [24 m, 24 m +
    24) fall in the heads ``_local`` computes, and its kept columns of their
    output are exactly those."""
    cfg = R.config("attn")
    mesh = make_mesh("1x4")
    model = shard_model(TransformerLM(cfg, device="meta"), mesh, rank)
    attn = model.layers[0].attn
    q0, hq, kv0, nkv, lo, hi = attn._local()
    assert not attn.whole and not attn.aligned
    c0 = rank * 24
    assert q0 * 16 <= c0 and c0 + 24 <= (q0 + hq) * 16
    assert (lo, hi) == (c0 - q0 * 16, c0 - q0 * 16 + 24)
    assert kv0 == q0 // 3 and kv0 + nkv == (q0 + hq - 1) // 3 + 1


def test_serve_cli_sharded_moe_at_2x2_gives_the_1x1_tokens(capsys):
    """``serve lm --arch qwen2-moe-a2.7b --reduced --mesh 2x2 --sharded``
    in f32: its default 4 x 64 prompt puts 128 tokens a rank against a
    group of 256, and each decode step 2 against 4; every rank's greedy
    tokens equal those of ``--mesh 1x1`` on the same seed for its first
    row. (In bf16 the two differ by a tie of the logits within rounding,
    after six tokens, as any two orders of the sums may.)"""
    from repro_torch.launch import serve

    base = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--override", "dtype=float32",
            "--max-new", "8", "--device", "cpu"]
    want = serve.main(base + ["--mesh", "1x1"]).numpy()
    capsys.readouterr()
    serve.main(base + ["--mesh", "2x2", "--sharded", "--timeout", str(RANK_TIMEOUT)])
    text = capsys.readouterr().out
    got = {int(r): np.array(t.split(), dtype=np.int64) for r, t in re.findall(
        r"\[rank (\d)\] \[serve\] sample tokens: \[([\d\s]+)\]", text)}
    assert sorted(got) == [0, 1, 2, 3], text
    mesh = make_mesh("2x2")
    for r, toks in got.items():
        np.testing.assert_array_equal(toks, want[2 * mesh.coords(r)[0], :16])
