"""One rank of the sharded MoE tests (tests/test_torch_moe_sharded.py).

Started by ``repro_torch.multihost.spawn_ranks`` with the
``REPRO_TORCH_DIST_*`` environment as one of four ranks:

    python tests/_torch_moe_rank.py WORK

It reads ``WORK/inputs.npz`` (the reference's weights per case, the
prompts, the forced tokens and the batch, written by the test), joins the
gloo group, makes its 1 x 4 and 2 x 2 meshes' axis groups once, and for
each case of ``CASES`` builds the sharded model from the reference's
weights and

* ``serve``: prefills its rows of the prompt and decodes teacher-forced on
  the reference's tokens; writes the gathered logits;
* ``train``: the sharded ``lm_loss`` (aux included) and every gathered
  gradient leaf, each layer's load-balancing loss from the sharded
  ``forward_train``, and the last-token logits of a prefill of the batch;
* ``layer``: layer 0's MoE alone on a fixed input and cotangent: the
  gradient of <out, cot> + aux with respect to the input and the router.

Results go to ``WORK/rank<r>.npz`` (the gathered leaves from rank 0 only).
"""
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference, param_names
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import embed_tokens, lm_loss, prefill_step, serve_step
from repro_torch.models.transformer import forward_train
from repro_torch.multihost import MultihostContext
from repro_torch.sharding.collectives import MeshComm
from repro_torch.sharding.placement import gather_whole, shard_batch, shard_model
from repro_torch.training.train_step import _sharded_grads

# name -> (arch, config overrides, mesh, what it runs)
CASES = {
    "qwen-serve": ("qwen2-moe-a2.7b", dict(dtype="float32", capacity_factor=1.25), "1x4",
                   "serve"),
    "dbrx-serve": ("dbrx-132b", dict(dtype="float32", capacity_factor=1.25), "1x4", "serve"),
    "qwen-2x2": ("qwen2-moe-a2.7b", dict(dtype="float32", n_layers=2, capacity_factor=1.0),
                 "2x2", "train"),
    "qwen-1x4": ("qwen2-moe-a2.7b", dict(dtype="float32", n_layers=2, capacity_factor=1.0),
                 "1x4", "train"),
    "dbrx-2x2": ("dbrx-132b", dict(dtype="float32", n_layers=2, capacity_factor=1.0), "2x2",
                 "train"),
    "dbrx-1x4": ("dbrx-132b", dict(dtype="float32", n_layers=2, capacity_factor=1.0), "1x4",
                 "train"),
    # 6 experts at tp 4: padded to 8, rank 3 owns two padded experts.
    "padded-1x4": ("qwen2-moe-a2.7b", dict(dtype="float32", n_layers=2, capacity_factor=1.0,
                                           n_experts=6), "1x4", "train"),
    "qwen-layer": ("qwen2-moe-a2.7b", dict(dtype="float32", n_layers=1, capacity_factor=1.0),
                   "1x4", "layer"),
}


def case_config(name):
    arch, over, _, _ = CASES[name]
    return configs.get_config(arch).reduced(**over)


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


def serve(model, mesh, rank, z, name, out):
    prompt = torch.from_numpy(z[f"{name}/prompt"])
    tp = mesh.shape["model"]
    with torch.inference_mode():
        logits, cache = prefill_step(model, shard_batch(prompt, mesh, rank),
                                     int(z["cache_len"]), tp=tp)
        out[f"{name}/prefill_logits"] = logits.numpy()
        steps = []
        for tok in z[f"{name}/tokens"]:
            logits, cache = serve_step(model, torch.from_numpy(tok), cache, tp=tp)
            steps.append(logits.numpy())
        out[f"{name}/step_logits"] = np.stack(steps)


def train(model, mesh, rank, comm, z, name, out):
    tp = mesh.shape["model"]
    tok, lab = (shard_batch(torch.from_numpy(a), mesh, rank) for a in z["batch"])
    loss = lm_loss(model, tok, lab, tp=tp)
    specs = [model.shard.specs[n] for n, _ in model.named_parameters()]
    grads = _sharded_grads(comm, specs, torch.autograd.grad(loss, tuple(model.parameters())))
    grads = [gather_whole(g, s, comm) for g, s in zip(grads, specs)]
    out[f"{name}/loss"] = float(loss.detach())
    if rank == 0:
        for pname, g in zip(param_names(model.cfg, tp), grads):
            out[f"{name}/grad/{pname}"] = g.numpy()
    with torch.no_grad():
        b, s = tok.shape
        positions = torch.arange(s, dtype=torch.int32).expand(b, s)
        _, aux = forward_train(model.layers, embed_tokens(model, tok), model.cfg, positions, tp)
        out[f"{name}/aux"] = float(aux)
        out[f"{name}/prefill_logits"] = prefill_step(model, tok, s, tp=tp)[0].numpy()


def layer(model, z, name, out):
    moe = model.layers[0].moe
    x = torch.from_numpy(z[f"{name}/x"]).requires_grad_(True)
    y, aux = moe(x)
    obj = (y * torch.from_numpy(z[f"{name}/cot"])).sum() + aux
    dx, drouter = torch.autograd.grad(obj, (x, moe.router))
    out[f"{name}/out"] = y.detach().numpy()
    out[f"{name}/dx"], out[f"{name}/drouter"] = dx.numpy(), drouter.numpy()


def main(work: str) -> int:
    torch.set_num_threads(1)
    world = MultihostContext.from_env()
    r = world.rank
    comms = {spec: MeshComm(make_mesh(spec), r, world) for spec in ("1x4", "2x2")}
    out: dict = {}
    with np.load(os.path.join(work, "inputs.npz")) as z:
        for name, (_, _, mesh_spec, kind) in CASES.items():
            cfg = case_config(name)
            comm = comms[mesh_spec]
            whole = lm_params_from_reference(tree(z, f"params/{name}"), cfg,
                                             tp=comm.mesh.shape["model"])
            model = shard_model(whole, comm.mesh, r, comm)
            out[f"{name}/experts"] = model.layers[0].moe.w_gate.shape[0]
            if kind == "serve":
                serve(model, comm.mesh, r, z, name, out)
            elif kind == "train":
                train(model, comm.mesh, r, comm, z, name, out)
            else:
                layer(model, z, name, out)
    out["collectives"] = np.array(repr({k: c.summary() for k, c in comms.items()}))
    np.savez(os.path.join(work, f"rank{r}.npz"), **out)
    world.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
