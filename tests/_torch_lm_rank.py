"""One rank of the sharded LM tests (tests/test_torch_lm_sharded.py).

Started by ``repro_torch.multihost.spawn_ranks`` with the
``REPRO_TORCH_DIST_*`` environment as one of four ranks:

    python tests/_torch_lm_rank.py WORK

It reads ``WORK/inputs.npz`` (the reference's weights, batches, prompt and
tokens, written by the test), joins the gloo group and

* serves at 1 x 4: prefill and decode, teacher-forced on the reference's
  tokens; writes the gathered logits and its cache blocks;
* trains at 2 x 2 (the same four processes, a second set of axis groups):
  the sharded ``lm_loss`` and its gathered gradient at the initial state,
  then two steps each plain, at grad_accum 2 and with int8 compression;
  writes losses, grad norms and the gathered params.

Results go to ``WORK/rank<r>.npz`` (the gathered leaves from rank 0 only).
"""
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference, param_names
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import gather_state, shard_state
from repro_torch.models.model import lm_loss, prefill_step, serve_step
from repro_torch.multihost import MultihostContext
from repro_torch.sharding.collectives import MeshComm
from repro_torch.sharding.placement import gather_whole, shard_batch, shard_model
from repro_torch.training.train_step import (_sharded_grads, make_train_step,
                                             train_state_init)

ARCH = "internlm2-1.8b"
SERVE = dict(dtype="float32", n_heads=8, n_kv_heads=2)
TRAIN = dict(dtype="float32", n_layers=2)
LR = 3e-3
STEPS = 2
VARIANTS = {"plain": dict(), "accum2": dict(grad_accum=2), "int8": dict(compress=True)}


def tree(z, prefix: str) -> dict:
    """The nested reference tree stored flat as ``prefix/a/b/name`` keys."""
    out: dict = {}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return out


def serve(world, z, out):
    cfg = configs.get_config(ARCH).reduced(**SERVE)
    mesh = make_mesh("1x4")
    comm = MeshComm(mesh, world.rank, world)
    model = shard_model(lm_params_from_reference(tree(z, "serve"), cfg, tp=4), mesh,
                        world.rank, comm)
    prompt = torch.from_numpy(z["prompt"])
    with torch.inference_mode():
        logits, cache = prefill_step(model, shard_batch(prompt, mesh, world.rank),
                                     int(z["cache_len"]), tp=4)
        out["prefill_logits"] = logits.numpy()
        out["cache_k"], out["cache_v"] = cache["k"].numpy(), cache["v"].numpy()
        steps = []
        for tok in z["tokens"]:
            logits, cache = serve_step(model, torch.from_numpy(tok), cache, tp=4)
            steps.append(logits.numpy())
        out["step_logits"] = np.stack(steps)
        out["decode_cache_k"] = cache["k"].numpy()


def train(world, z, out):
    cfg = configs.get_config(ARCH).reduced(**TRAIN)
    mesh = make_mesh("2x2")
    comm = MeshComm(mesh, world.rank, world)
    whole = lm_params_from_reference(tree(z, "train"), cfg, tp=2)
    state0 = shard_state(train_state_init(whole), cfg, mesh, world.rank, "cpu")
    # The sharded loss and gradient at the initial state, gathered.
    model = shard_model(whole, mesh, world.rank, comm)
    tok, lab = z["batches"][0]
    loss = lm_loss(model, shard_batch(torch.from_numpy(tok), mesh, world.rank),
                   shard_batch(torch.from_numpy(lab), mesh, world.rank), tp=2)
    specs = [model.shard.specs[n] for n, _ in model.named_parameters()]
    grads = _sharded_grads(comm, specs, torch.autograd.grad(loss, tuple(model.parameters())))
    grads = [gather_whole(g, s, comm) for g, s in zip(grads, specs)]
    out["grad_loss"] = float(loss.detach())
    names = param_names(cfg, 2)
    for name, g in zip(names, grads):
        out[f"grad/{name}"] = g.numpy()
    for label, kw in VARIANTS.items():
        step = make_train_step(cfg, tp=2, lr=LR, comm=comm, **kw)
        state, err, losses, norms = state0, None, [], []
        for tok, lab in z["batches"][:STEPS]:
            if kw.get("compress"):
                state, m, err = step(state, tok, lab, err)
            else:
                state, m = step(state, tok, lab)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{label}/loss"], out[f"{label}/grad_norm"] = np.array(losses), np.array(norms)
        whole_state = gather_state(state, cfg, comm)
        for name, p in zip(names, whole_state.params):
            out[f"{label}/param/{name}"] = p.numpy()
    out["collectives"] = np.array(repr(comm.summary()))


def main(work: str) -> int:
    torch.set_num_threads(1)
    world = MultihostContext.from_env()
    out: dict = {}
    with np.load(os.path.join(work, "inputs.npz")) as z:
        serve(world, z, out)
        train(world, z, out)
    if world.rank != 0:
        out = {k: v for k, v in out.items() if "/param/" not in k and not k.startswith("grad/")}
    np.savez(os.path.join(work, f"rank{world.rank}.npz"), **out)
    world.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
