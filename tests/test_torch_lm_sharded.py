"""The dense LM split over a D x M mesh of rank processes, against the JAX
package and against the port's whole-tensor runs, on the CPU.

Four gloo ranks (tests/_torch_lm_rank.py, each spawned with its own
timeout) first serve at 1 x 4 and then train at 2 x 2, on the reference's
``init_params(key, cfg, tp)`` weights carried across with
``convert.lm_params_from_reference``:

* (a) shards of every leaf of every configuration, of a cache and of a
  batch reassemble bitwise (no processes);
* (b) ``LMMesh.coords`` is the reference's device order and ``local_shard``
  its ``addressable_shards`` (a subprocess with 8 XLA host devices);
* (c) training at 2 x 2 (reduced internlm2, f32): the sharded loss and
  every gathered gradient leaf, and two steps each plain, at grad_accum 2
  and with int8 compression, against the port's whole step at tp = 2 and
  the reference's jitted step on its (2, 2) mesh;
* (d) serving at 1 x 4 with 8 query and 2 KV heads (the expanded cache,
  r = 2, split one head a rank): prefill logits, cache blocks and decode
  logits (teacher-forced) against the reference's ``serve_step`` at tp = 4;
* (e) a sharded checkpoint resumes bitwise and the reference reads it;
* (f) a failed rendezvous raises (the MoE's split:
  tests/test_torch_moe_sharded.py; the recurrent stacks':
  tests/test_torch_recurrent_sharded.py; the sharding rules' fallbacks, the
  sequence-split cache among them: tests/test_torch_fallback_sharded.py).

Tolerances are tests/test_torch_tensor_parallel.py's: losses and grad
norms at rtol 1e-5, f32 tensors (logits, caches, gradients) at 1e-4. After
the first int8-compressed step the loss and the grad norm are held at 1e-3,
as tests/test_torch_training.py holds them (the quantizer rounds to a grid of
absmax / 127, so where two runs differ in the last bits an entry may land
in the next bin). Parameters after Adam steps are held at 10 lr absolute,
as there: Adam's first update is lr times the sign of the gradient, so an
entry whose gradient is zero to within rounding may move either way.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.training.serve import make_decode_step, make_prefill_step  # noqa: E402
from repro.training.train_step import train_state_init as jtrain_state_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.checkpoint import latest_checkpoint, load_checkpoint  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.attention import cache_heads_local  # noqa: E402
from repro_torch.models.model import init_params, lm_loss, prefill_step  # noqa: E402
from repro_torch.multihost import spawn_ranks  # noqa: E402
from repro_torch.sharding.collectives import MeshComm  # noqa: E402
from repro_torch.sharding.placement import (assemble, local_shard, parameter_specs,  # noqa: E402
                                            shard_batch, shard_cache)
from repro_torch.sharding.rules import cache_specs  # noqa: E402
from repro_torch.training.train_step import make_train_step, train_state_init  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_lm_rank as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_lm_rank.py")
RANK_TIMEOUT = 120.0
F32 = dict(rtol=1e-4, atol=1e-4)
B, S, NEW = 2, 24, 6
TRAIN_B, TRAIN_S = 4, 64


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


# The reference's step on its (2, 2) mesh of XLA host devices, as
# tests/test_launch_specs.py runs it: params, Adam state and batches placed
# with NamedSharding, the step jitted with in_shardings.
_MESH_STEP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch.mesh import make_test_mesh
    from repro.sharding.compat import set_mesh
    from repro.sharding.rules import batch_spec, param_specs
    from repro.training.train_step import make_train_step, train_state_init
    work, lr, steps = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
    z = np.load(os.path.join(work, "inputs.npz"))
    params = {}
    for key in z.files:
        if key.startswith("train/"):
            node = params
            parts = key.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(z[key])
    cfg = configs.get_config("internlm2-1.8b").reduced(dtype="float32", n_layers=2)
    mesh = make_test_mesh((2, 2))
    out = {}
    for label, kw in (("plain", {}), ("accum2", {"grad_accum": 2}), ("int8", {"compress": True})):
        state = train_state_init(params)
        pspec = param_specs(state.params, mesh)
        sspec = type(state)(params=pspec, opt=type(state.opt)(step=P(), mu=pspec, nu=pspec),
                            step=P())
        ssh = jax.tree.map(lambda s: NamedSharding(mesh, s), sspec,
                           is_leaf=lambda x: isinstance(x, P))
        esh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspec,
                           is_leaf=lambda x: isinstance(x, P))
        bsh = NamedSharding(mesh, batch_spec(mesh, z["batches"].shape[2]))
        step = make_train_step(cfg, tp=2, lr=lr, **kw)
        shard = (ssh, bsh, bsh, esh) if kw.get("compress") else (ssh, bsh, bsh)
        fn = jax.jit(step, in_shardings=shard)
        err = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        losses, norms = [], []
        with set_mesh(mesh):
            state = jax.device_put(state, ssh)
            for tok, lab in z["batches"][:steps]:
                args = (state, jnp.asarray(tok), jnp.asarray(lab))
                if kw.get("compress"):
                    state, m, err = fn(*args, err)
                else:
                    state, m = fn(*args)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[label + "/loss"], out[label + "/grad_norm"] = np.array(losses), np.array(norms)
        for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            name = "/".join(str(k.key) for k in path)
            out[label + "/param/" + name] = np.asarray(leaf, np.float32)
    np.savez(os.path.join(work, "mesh_step.npz"), **out)
    print("MESH_STEP_OK")
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's serving and training inputs, the four ranks' run and
    the reference's mesh step (started together), and the port's whole
    model at the same weights."""
    work = str(tmp_path_factory.mktemp("lm_sharded"))
    jcfg_s = jconfigs.get_config(R.ARCH).reduced(**R.SERVE)
    params_s = jinit_params(jax.random.key(11), jcfg_s, 4)
    prompt = np.random.default_rng(0).integers(0, jcfg_s.vocab, (B, S)).astype(np.int32)
    logits, cache = jax.jit(make_prefill_step(jcfg_s, S + NEW, tp=4))(params_s,
                                                                      jnp.asarray(prompt))
    ref = {"prefill_logits": np.asarray(logits), "step_logits": [], "tokens": [],
           "cache": {k: np.asarray(v) for k, v in cache.items() if k != "pos"}}
    decode = jax.jit(make_decode_step(jcfg_s, tp=4))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    for _ in range(NEW - 1):
        ref["tokens"].append(np.array(tok))
        tok, logits, cache = decode(params_s, tok, cache)
        ref["step_logits"].append(np.asarray(logits))
    jcfg_t = jconfigs.get_config(R.ARCH).reduced(**R.TRAIN)
    params_t = jinit_params(jax.random.key(5), jcfg_t, 2)
    rng = np.random.default_rng(9)
    batches = rng.integers(0, jcfg_t.vocab, (R.STEPS, 2, TRAIN_B, TRAIN_S)).astype(np.int32)
    np.savez(os.path.join(work, "inputs.npz"), prompt=prompt, cache_len=S + NEW,
             tokens=np.stack(ref["tokens"]), batches=batches,
             **_flat(_np32(params_s), "serve"), **_flat(_np32(params_t), "train"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    mesh_step = subprocess.Popen([sys.executable, "-c", _MESH_STEP, work, str(R.LR),
                                  str(R.STEPS)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
    try:
        results = spawn_ranks([sys.executable, HELPER, work], 4, timeout_s=RANK_TIMEOUT)
        for r, (code, text) in enumerate(results):
            assert code == 0, f"rank {r} exited with {code}:\n{text}"
        text, _ = mesh_step.communicate(timeout=300)
    finally:
        if mesh_step.poll() is None:
            mesh_step.kill()
    assert mesh_step.returncode == 0 and "MESH_STEP_OK" in text, text
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(4)]
    tcfg_t = tconfigs.get_config(R.ARCH).reduced(**R.TRAIN)
    return dict(ref=ref, ranks=ranks, jcfg_t=jcfg_t, params_t=params_t, batches=batches,
                cfg_s=tconfigs.get_config(R.ARCH).reduced(**R.SERVE), cfg_t=tcfg_t,
                whole_t=convert.lm_params_from_reference(_np32(params_t), tcfg_t, tp=2),
                mesh_step=dict(np.load(os.path.join(work, "mesh_step.npz"))))


# -- (a) round trips and the mesh ------------------------------------------------

@pytest.mark.parametrize("mesh_spec", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_leaf_shards_and_reassembles_bitwise(arch, mesh_spec):
    cfg = tconfigs.get_config(arch).reduced()
    mesh = make_mesh(mesh_spec)
    model = init_params(cfg, torch.Generator().manual_seed(1), tp=mesh.shape["model"])
    specs = parameter_specs(model, mesh)
    for name, p in model.named_parameters():
        shards = [local_shard(p.detach(), specs[name], mesh, mesh.coords(r))
                  for r in range(mesh.size)]
        assert torch.equal(assemble(shards, specs[name], mesh), p.detach()), name


def test_cache_and_batch_shard_and_reassemble_bitwise():
    cfg = tconfigs.get_config(R.ARCH).reduced(**R.SERVE)
    model = init_params(cfg, torch.Generator().manual_seed(2), tp=4)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (4, 16)))
    with torch.no_grad():
        _, cache = prefill_step(model, prompt, prompt.shape[1] + 2, tp=4)
    for spec_s in ("1x4", "2x2"):
        mesh = make_mesh(spec_s)
        specs = cache_specs(cache, mesh)
        pieces = [shard_cache(cache, mesh, r) for r in range(mesh.size)]
        for key in ("k", "v"):
            assert torch.equal(assemble([p[key] for p in pieces], specs[key], mesh), cache[key])
        rows = [shard_batch(prompt, mesh, r) for r in range(mesh.size)]
        assert torch.equal(torch.cat(rows[::mesh.shape["model"]]), prompt)


def test_mesh_coords_ranks_and_axis_groups():
    mesh = make_mesh("2x4")
    assert [mesh.coords(r) for r in range(8)] == [(d, m) for d in range(2) for m in range(4)]
    assert all(mesh.rank(mesh.coords(r)) == r for r in range(8))
    assert mesh.axis_groups("model") == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert mesh.axis_groups("data") == [(0, 4), (1, 5), (2, 6), (3, 7)]
    with pytest.raises(ValueError):
        mesh.coords(8)


_ORDER = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_test_mesh
    cases = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
             ((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
    specs = [("data", "model"), ("model", "data"), (None, ("data", "model")),
             (("pod", "data"), "model"), ("model", None)]
    out = {}
    for shape, axes in cases:
        mesh = make_test_mesh(shape, axes)
        devs = list(mesh.devices.flat)
        out[str(shape)] = {"coords": [list(np.argwhere(mesh.devices == d)[0].tolist())
                                      for d in devs]}
        whole = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        for spec in specs:
            if any(a not in axes for e in spec if e for a in ((e,) if isinstance(e, str) else e)):
                continue
            arr = jax.device_put(whole, NamedSharding(mesh, P(*spec)))
            by_dev = {s.device: np.asarray(s.data).tolist() for s in arr.addressable_shards}
            out[str(shape)][json.dumps(spec)] = [by_dev[d] for d in devs]
    print("ORDER" + json.dumps(out))
""")


def test_mesh_order_and_local_shards_match_named_sharding():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _ORDER], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    import json

    got = json.loads(r.stdout.split("ORDER", 1)[1])
    whole = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for shape, axes in [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
                        ((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]:
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(shape, axes)
        rec = got[str(shape)]
        assert [list(mesh.coords(r)) for r in range(mesh.size)] == rec["coords"]
        for key, blocks in rec.items():
            if key == "coords":
                continue
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in json.loads(key))
            for r, block in enumerate(blocks):
                np.testing.assert_array_equal(
                    local_shard(whole, spec, mesh, mesh.coords(r)).numpy(), np.array(block),
                    err_msg=f"{shape} {spec} rank {r}")


# -- (d) serving at 1 x 4 -------------------------------------------------------

def test_sharded_serving_matches_reference_at_tp4(run):
    ref, ranks = run["ref"], run["ranks"]
    mesh = make_mesh("1x4")
    whole = {k: torch.from_numpy(np.array(v)) for k, v in ref["cache"].items()}
    want = cache_specs(whole, mesh)
    assert cache_heads_local(run["cfg_s"], 2, 4) == 1
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["prefill_logits"], ref["prefill_logits"], **F32)
        for key in ("k", "v"):
            block = local_shard(whole[key], want[key], mesh, mesh.coords(r)).numpy()
            assert out[f"cache_{key}"].shape == block.shape == (4, B, S + NEW, 1, 32)
            np.testing.assert_allclose(out[f"cache_{key}"][:, :, :S], block[:, :, :S], **F32)
        for got, w in zip(out["step_logits"], ref["step_logits"]):
            np.testing.assert_allclose(got, w, **F32)
        np.testing.assert_array_equal(out["prefill_logits"], ranks[0]["prefill_logits"])


# -- (c) training at 2 x 2 ------------------------------------------------------

def test_sharded_loss_and_gradient_match_the_whole_and_the_reference(run):
    cfg, whole = run["cfg_t"], run["whole_t"]
    tok, lab = run["batches"][0]
    loss = lm_loss(whole, torch.from_numpy(tok), torch.from_numpy(lab), tp=2)
    grads = torch.autograd.grad(loss, tuple(whole.parameters()))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), run["jcfg_t"], tp=2))(
        run["params_t"])
    out = run["ranks"][0]
    np.testing.assert_allclose(out["grad_loss"], float(loss.detach()), rtol=1e-5)
    np.testing.assert_allclose(out["grad_loss"], float(jloss), rtol=1e-5)
    names = convert.param_names(cfg, 2)
    jwant = convert.tensors_from_reference_tree(names, _np32(jgrads))
    for name, g, jg in zip(names, grads, jwant):
        _scaled(out[f"grad/{name}"], g.numpy(), 1e-4, name)
        _scaled(out[f"grad/{name}"], np.asarray(jg), 1e-4, name)


@pytest.mark.parametrize("label", list(R.VARIANTS))
def test_sharded_train_steps_match_the_whole_and_the_reference_mesh(run, label):
    cfg, kw = run["cfg_t"], R.VARIANTS[label]
    step = make_train_step(cfg, tp=2, lr=R.LR, **kw)
    state, err, losses, norms = train_state_init(run["whole_t"]), None, [], []
    for tok, lab in run["batches"]:
        if kw.get("compress"):
            state, m, err = step(state, tok, lab, err)
        else:
            state, m = step(state, tok, lab)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ref = run["mesh_step"]
    names = convert.param_names(cfg, 2)
    jparams = convert.tensors_from_reference_tree(
        names, {k: v for k, v in _unflat(ref, f"{label}/param/").items()})
    for r, out in enumerate(run["ranks"]):
        for key, mine in (("loss", losses), ("grad_norm", norms)):
            for want in (mine, ref[f"{label}/{key}"]):
                np.testing.assert_allclose(out[f"{label}/{key}"][:1], want[:1], rtol=1e-5)
                np.testing.assert_allclose(out[f"{label}/{key}"], want,
                                           rtol=1e-3 if kw.get("compress") else 1e-5)
        np.testing.assert_array_equal(out[f"{label}/loss"], run["ranks"][0][f"{label}/loss"])
    out = run["ranks"][0]
    for name, p, jp in zip(names, state.params, jparams):
        got = out[f"{label}/param/{name}"]
        np.testing.assert_allclose(got, p.detach().numpy(), rtol=0, atol=10 * R.LR, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(jp), rtol=0, atol=10 * R.LR, err_msg=name)


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


# -- (e) checkpoints --------------------------------------------------------------

def _cli(ckpt, *extra):
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--override",
            "n_layers=2", "--batch", "4", "--seq", "32", "--mesh", "2x2", "--sharded",
            "--device", "cpu", "--timeout", str(RANK_TIMEOUT), "--ckpt-dir", ckpt, *extra]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    text, _ = proc.communicate(timeout=2 * RANK_TIMEOUT)
    assert proc.returncode == 0, text
    return text


def test_sharded_checkpoint_resumes_bitwise_and_loads_in_the_reference(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight, first = _cli(a, "--steps", "2", "--ckpt-every", "2"), _cli(b, "--steps", "1")
    text = _finish(straight)
    _finish(first)
    resumed = _finish(_cli(b, "--steps", "1", "--resume"))
    assert "[rank 0] [train] resumed from" in resumed and "sharded: params" in text
    flat_a, man_a = load_checkpoint(latest_checkpoint(a))
    flat_b, man_b = load_checkpoint(latest_checkpoint(b))
    assert man_a["step"] == man_b["step"] == 2 and sorted(flat_a) == sorted(flat_b)
    for key in flat_a:
        assert np.array_equal(np.asarray(flat_a[key].float() if torch.is_tensor(flat_a[key])
                                         else flat_a[key]),
                              np.asarray(flat_b[key].float() if torch.is_tensor(flat_b[key])
                                         else flat_b[key])), key
    jcfg = jconfigs.get_config(R.ARCH).reduced(n_layers=2)
    template = jtrain_state_init(jinit_params(jax.random.key(0), jcfg))
    restored, manifest = jckpt.restore_train_state(latest_checkpoint(a), template)
    assert int(restored.step) == 2 and manifest["extras"]["stream"]["batch_idx"] == 2
    tcfg = tconfigs.get_config(R.ARCH).reduced(n_layers=2)
    state, _ = ttrain.restore_state(latest_checkpoint(a), ttrain.whole_template(tcfg),
                                    convert.param_names(tcfg), "cpu")
    got = convert.train_state_to_reference(state, tcfg)
    for x, y in zip(jax.tree.leaves(_np32(restored.params)), jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree.leaves(_np32(restored.opt.mu)), jax.tree.leaves(got["opt"]["mu"])):
        np.testing.assert_array_equal(x, y)


def test_row_parallel_f32_product_backward_is_the_16_bit_products():
    """``layers._MatmulF32`` (the card's row-parallel product: bf16
    operands, the GEMM's f32 accumulator out) differentiates as ``x @ w``
    of the same operands does, bitwise; on the CPU ``matmul_f32`` widens
    the operands, which forms the same exact products."""
    from repro_torch.models.layers import _MatmulF32, matmul_f32

    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 16, generator=g).bfloat16()
    w = torch.randn(16, 8, generator=g).bfloat16()
    up = torch.randn(2, 6, 8, generator=g).bfloat16()
    ctx = type("Ctx", (), {"saved_tensors": (x, w), "needs_input_grad": (True, True)})()
    gx, gw = _MatmulF32.backward(ctx, up.float())
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (xr @ wr).backward(up)
    assert gx.dtype == gw.dtype == torch.bfloat16
    assert torch.equal(gx, xr.grad) and torch.equal(gw, wr.grad)
    out = matmul_f32(x, w)
    assert out.dtype == torch.float32
    assert torch.equal(out, x.float() @ w.float())


# -- (f) refusals ------------------------------------------------------------------

def test_failed_rendezvous_raises():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(Exception):
        MeshComm.connect(make_mesh("1x2"), f"127.0.0.1:{port}", 1, timeout_s=2,
                         host_store=False)
