"""One rank of the sharded recurrent-stack tests
(tests/test_torch_recurrent_sharded.py).

Started by ``repro_torch.multihost.spawn_ranks`` with the
``REPRO_TORCH_DIST_*`` environment as one of four ranks:

    python tests/_torch_recurrent_rank.py WORK

It reads ``WORK/inputs.npz`` (the reference's weights per architecture, the
prompts, the forced tokens and the batch, written by the test), joins the
gloo group, makes its 1 x 4 and 2 x 2 meshes' axis groups once, and for
each case of ``CASES`` builds the sharded model from the reference's
weights and

* ``serve``: prefills its rows of the prompt and decodes teacher-forced on
  the reference's tokens; writes the gathered logits and its blocks of the
  prefilled cache;
* ``train``: the sharded ``lm_loss`` and every gathered gradient leaf on
  the batch's first ``rows`` rows, and the last-token logits of a prefill
  of them;
* ``fault``: as ``train`` with ``ShardContext.partial_leaves`` planted to
  sum the region's leaves' gradients over 'model' once too few (``few``:
  not at all) or once too often (``often``: twice);
* ``exchange``: the all-to-all over 'model' of a tensor of this rank's own,
  forward, round trip and backward.

Each case's collective counters are kept. Results go to ``WORK/rank<r>.npz``
(the gathered leaves from rank 0 only).
"""
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference, param_names
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import lm_loss, prefill_step, serve_step
from repro_torch.multihost import MultihostContext
from repro_torch.sharding import placement
from repro_torch.sharding.collectives import MeshComm, exchange
from repro_torch.sharding.placement import gather_whole, shard_batch, shard_model
from repro_torch.training.train_step import _sharded_grads

ARCHS = ("zamba2-2.7b", "rwkv6-3b")
# name -> (arch, mesh, what it runs, batch rows / planted fault)
CASES = {
    "zamba2-serve": ("zamba2-2.7b", "1x4", "serve", None),
    "rwkv6-serve": ("rwkv6-3b", "1x4", "serve", None),
    "zamba2-2x2": ("zamba2-2.7b", "2x2", "train", 4),
    "zamba2-1x4": ("zamba2-2.7b", "1x4", "train", 4),
    "rwkv6-2x2": ("rwkv6-3b", "2x2", "train", 4),
    "rwkv6-1x4": ("rwkv6-3b", "1x4", "train", 4),
    # 2 rows at 1 x 4: FULL_BATCH resolves to no split over 'model'.
    "zamba2-rows2": ("zamba2-2.7b", "1x4", "train", 2),
    "rwkv6-rows2": ("rwkv6-3b", "1x4", "train", 2),
    "zamba2-few": ("zamba2-2.7b", "1x4", "fault", "few"),
    "zamba2-often": ("zamba2-2.7b", "1x4", "fault", "often"),
    "rwkv6-few": ("rwkv6-3b", "1x4", "fault", "few"),
    "rwkv6-often": ("rwkv6-3b", "1x4", "fault", "often"),
    "exchange": (None, "1x4", "exchange", None),
}
EXCHANGE_SHAPE = (8, 3, 4, 5)


def arch_config(arch):
    """The reduced configuration in f32: zamba2 at two groups of two mamba2
    layers (16 SSD heads, the shared block's 4 heads), rwkv6 at 4 layers of
    4 heads."""
    return configs.get_config(arch).reduced(dtype="float32")


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


def exchange_input(rank: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(EXCHANGE_SHAPE)
                            .astype(np.float32))


def serve(model, mesh, rank, z, name, out):
    arch = CASES[name][0]
    prompt = torch.from_numpy(z[f"{arch}/prompt"])
    with torch.inference_mode():
        logits, cache = prefill_step(model, shard_batch(prompt, mesh, rank), int(z["cache_len"]),
                                     tp=4)
        out[f"{name}/prefill_logits"] = logits.numpy()
        for k, v in cache.items():
            if torch.is_tensor(v):
                out[f"{name}/cache/{k}"] = v.numpy().copy()   # decode writes K/V in place
        steps = []
        for tok in z[f"{arch}/tokens"]:
            logits, cache = serve_step(model, torch.from_numpy(tok), cache, tp=4)
            steps.append(logits.numpy())
        out[f"{name}/step_logits"] = np.stack(steps)


def train(model, mesh, rank, comm, z, name, rows, out):
    tp = mesh.shape["model"]
    tok, lab = (shard_batch(torch.from_numpy(a[:rows]), mesh, rank) for a in z["batch"])
    loss = lm_loss(model, tok, lab, tp=tp)
    specs = [model.shard.specs[n] for n, _ in model.named_parameters()]
    grads = _sharded_grads(comm, specs, torch.autograd.grad(loss, tuple(model.parameters())))
    grads = [gather_whole(g, s, comm) for g, s in zip(grads, specs)]
    out[f"{name}/loss"] = float(loss.detach())
    if rank == 0:
        for pname, g in zip(param_names(model.cfg, tp), grads):
            out[f"{name}/grad/{pname}"] = g.numpy()
    with torch.no_grad():
        out[f"{name}/prefill_logits"] = prefill_step(model, tok, tok.shape[1], tp=tp)[0].numpy()


def fault(model, mesh, rank, comm, z, name, kind, out):
    orig = placement.ShardContext.partial_leaves
    planted = {"few": lambda self, *leaves, tag=None: leaves,
               "often": lambda self, *leaves, tag=None: orig(self, *orig(self, *leaves, tag=tag),
                                                             tag=tag)}[kind]
    placement.ShardContext.partial_leaves = planted
    try:
        train(model, mesh, rank, comm, z, name, 4, out)
    finally:
        placement.ShardContext.partial_leaves = orig


def exchange_case(comm, rank, out):
    x = exchange_input(rank).requires_grad_(True)
    y = exchange(x, comm, "model", 0, 2, "test")
    back = exchange(y, comm, "model", 2, 0, "test")
    cot = torch.from_numpy(np.random.default_rng(200 + rank).standard_normal(tuple(y.shape))
                           .astype(np.float32))
    (gx,) = torch.autograd.grad((y * cot).sum(), (x,))
    out["exchange/out"] = y.detach().numpy()
    out["exchange/round_trip_equal"] = bool(torch.equal(back.detach(), x.detach()))
    out["exchange/grad"] = gx.numpy()
    out["exchange/grad_is_inverse"] = bool(torch.equal(gx, comm.all_to_all(cot, "model", 2, 0)))
    bf = x.detach().bfloat16()
    out["exchange/bf16_round_trip_equal"] = bool(torch.equal(
        comm.all_to_all(comm.all_to_all(bf, "model", 0, 2), "model", 2, 0), bf))


def main(work: str) -> int:
    torch.set_num_threads(1)
    world = MultihostContext.from_env()
    r = world.rank
    comms = {spec: MeshComm(make_mesh(spec), r, world) for spec in ("1x4", "2x2")}
    out: dict = {}
    with np.load(os.path.join(work, "inputs.npz")) as z:
        whole = {a: lm_params_from_reference(tree(z, f"params/{a}"), arch_config(a), tp=4)
                 for a in ARCHS}
        for name, (arch, mesh_spec, kind, arg) in CASES.items():
            comm = comms[mesh_spec]
            comm.reset_stats()
            if kind == "exchange":
                exchange_case(comm, r, out)
            else:
                model = shard_model(whole[arch], comm.mesh, r, comm)
                if kind == "serve":
                    serve(model, comm.mesh, r, z, name, out)
                elif kind == "train":
                    train(model, comm.mesh, r, comm, z, name, arg, out)
                else:
                    fault(model, comm.mesh, r, comm, z, name, arg, out)
            out[f"{name}/collectives"] = np.array(repr(comm.summary()))
    np.savez(os.path.join(work, f"rank{r}.npz"), **out)
    world.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
