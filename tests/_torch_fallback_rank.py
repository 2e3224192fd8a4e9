"""One rank of the sharding-fallback tests (tests/test_torch_fallback_sharded.py).

Started by ``repro_torch.multihost.spawn_ranks`` with the
``REPRO_TORCH_DIST_*`` environment as one of four ranks:

    python tests/_torch_fallback_rank.py WORK

It reads ``WORK/inputs.npz`` (the reference's weights per configuration,
the prompts, the forced tokens and the batches, written by the test), joins
the gloo group, makes its 2 x 2 and 1 x 4 meshes' axis groups once, and for
each case of ``CASES`` builds the sharded model from the reference's
weights and

* ``serve``: prefills its rows of the prompt into a cache of the case's
  length and decodes teacher-forced on the reference's tokens; writes the
  gathered logits and its blocks of the cache after the last step;
* ``train``: the sharded ``lm_loss`` and every gathered gradient leaf;
* ``layer``: layer 0's MoE alone on a fixed input and cotangent: its
  output, the gradient of <out, cot> + aux with respect to the input and
  the router, and the routing of its tokens (expert, slot, keep).

Last, ``exchange``: ``collectives.DeviceExchange``'s rounds, chunks and
barriers with its buffers in shared files (``FileExchange``, the CPU's
stand-in for the card's memory, 4 KiB so that every tensor takes several
rounds), against gloo's all-gather and all-to-all of the same bytes.

Each case's collective counters are kept. Results go to ``WORK/rank<r>.npz``
(the gathered gradient leaves from rank 0 only).
"""
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference, param_names
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import lm_loss, prefill_step, serve_step
from repro_torch.models.moe import MoE
from repro_torch.multihost import MultihostContext
from repro_torch.sharding.collectives import DeviceExchange, MeshComm
from repro_torch.sharding.placement import gather_whole, shard_batch, shard_model
from repro_torch.training.train_step import _sharded_grads

# Reduced configurations (f32) whose dimensions the model axis does not
# divide, or whose dispatch groups straddle the data split:
# name -> (architecture, overrides, mesh)
CONFIGS = {
    # 2 x 2: 256 tokens a rank against a group of 512; capacity binds.
    "moe": ("qwen2-moe-a2.7b", dict(n_layers=2, capacity_factor=1.0), "2x2"),
    # 1 x 4: 6 query heads of 16 (24 columns a rank = 1.5 heads), 2 KV
    # heads (8 columns a rank), so 2 cache heads: a sequence-split or
    # whole cache.
    "attn": ("minitron-4b", dict(n_heads=6, n_kv_heads=2, head_dim=16), "1x4"),
    # 6 rwkv6 heads of 32 (48 channels a rank = 1.5 heads).
    "rwkv6": ("rwkv6-3b", dict(n_heads=6), "1x4"),
    # 6 SSD heads of 32 (d_inner 192: 48 channels a rank = 1.5 heads).
    "zamba2": ("zamba2-2.7b", dict(d_model=96, ssm_head_dim=32), "1x4"),
    # d_ff 258: the channel mix's w_cm_1 and w_cm_2 replicated over 'model'.
    "ff258": ("rwkv6-3b", dict(d_ff=258), "1x4"),
    # Every leaf of a block replicated over 'model', which runs whole on
    # every rank: 5 heads of 14 (70 columns), d_ff 258 and a vocabulary of
    # 258 (the embedding and the head); d_inner 198 (6 SSD heads of 33);
    # rwkv6's H K of 150 (5 heads of 30).
    "attn-rep": ("minitron-4b", dict(n_heads=5, n_kv_heads=5, head_dim=14, d_ff=258,
                                     vocab=258), "1x4"),
    "zamba2-rep": ("zamba2-2.7b", dict(d_model=99, ssm_head_dim=33), "1x4"),
    "rwkv6-rep": ("rwkv6-3b", dict(n_heads=5, head_dim=30), "1x4"),
}
# name -> (configuration, what it runs, cache length or None); a serving
# case's prompt fills all but NEW slots of its cache.
NEW = 6
CASES = {
    "moe-serve": ("moe", "serve", 262),     # 2 x 256 prompt: 256 tokens a rank
    "moe-train": ("moe", "train", None),
    "moe-layer": ("moe", "layer", None),   # 1 x 256 tokens a rank: one group of 512
    "moe-wide": ("moe", "layer", None),    # 1 x 1536 a rank: groups of 1024, one split
    "attn-seq": ("attn", "serve", 32),       # 32 slots: 8 a rank (sequence split)
    "attn-whole": ("attn", "serve", 31),     # 31 slots: the whole cache on every rank
    "attn-train": ("attn", "train", None),
    "rwkv6-serve": ("rwkv6", "serve", 30),
    "rwkv6-train": ("rwkv6", "train", None),
    "zamba2-serve": ("zamba2", "serve", 30),
    "zamba2-train": ("zamba2", "train", None),
    "ff258-serve": ("ff258", "serve", 30),
    "ff258-train": ("ff258", "train", None),
    "attn-rep-serve": ("attn-rep", "serve", 32),
    "attn-rep-train": ("attn-rep", "train", None),
    "zamba2-rep-serve": ("zamba2-rep", "serve", 30),
    "zamba2-rep-train": ("zamba2-rep", "train", None),
    "rwkv6-rep-serve": ("rwkv6-rep", "serve", 30),
    "rwkv6-rep-train": ("rwkv6-rep", "train", None),
}


class FileExchange(DeviceExchange):
    """``DeviceExchange`` with each rank's buffer a shared file in ``DIR``."""

    BYTES = 4096
    DIR = None

    def _allocate(self) -> tuple:
        path = os.path.join(self.DIR, f"exchange.{self.rank}")
        return torch.from_file(path, shared=True, size=self.BYTES, dtype=torch.uint8), path

    def _open(self, path) -> torch.Tensor:
        return torch.from_file(path, shared=True, size=self.BYTES, dtype=torch.uint8)

    def _place(self) -> str:
        return "host"

    def _sync(self) -> None:
        pass


def exchange(world, comms, work, out):
    FileExchange.DIR = work
    with torch.inference_mode():    # as serving makes it: its buffer must stay writable after
        ex = FileExchange.of(world, torch.device("cpu"))
    rng = np.random.default_rng(300 + world.rank)
    for spec, comm in comms.items():
        for axis in comm.mesh.axis_names:
            n = comm.size(axis)
            if n == 1:
                continue
            for nbytes in (7, 4096, 20_000):
                wire = torch.from_numpy(rng.integers(0, 256, (1, nbytes), dtype=np.uint8))
                pieces = torch.from_numpy(rng.integers(0, 256, (n, nbytes), dtype=np.uint8))
                key = f"exchange/{spec}/{axis}/{nbytes}"
                out[f"{key}/gather"] = bool(torch.equal(ex.all_gather(wire[0], comm, axis),
                                                        comm._gather_bytes(wire, axis)))
                out[f"{key}/all_to_all"] = bool(torch.equal(ex.all_to_all(pieces, comm, axis),
                                                            comm._exchange(pieces, axis)[0]))
    out["exchange/barriers"] = ex.flags[world.rank].tolist()
    # One pair of the 2 x 2 mesh passes a round on 'model' that the other
    # does not; a 1 x 4 mesh made after it starts every count in step.
    if comms["2x2"].index("data") == 0:
        ex.all_gather(torch.zeros(7, dtype=torch.uint8), comms["2x2"], "model")
    comm = MeshComm(make_mesh("1x4"), world.rank, world)
    out["realign/barriers"] = ex.flags[world.rank].tolist()
    wire = torch.from_numpy(rng.integers(0, 256, (1, 20_000), dtype=np.uint8))
    out["realign/gather"] = bool(torch.equal(ex.all_gather(wire[0], comm, "model"),
                                             comm._gather_bytes(wire, "model")))


def config(name):
    arch, over, _ = CONFIGS[name]
    return configs.get_config(arch).reduced(dtype="float32", **over)


def tp_of(name) -> int:
    return make_mesh(CONFIGS[name][2]).shape["model"]


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
    tp = mesh.shape["model"]
    prompt = torch.from_numpy(z[f"{name}/prompt"])
    with torch.inference_mode():
        logits, cache = prefill_step(model, shard_batch(prompt, mesh, rank), int(z[f"{name}/len"]),
                                     tp=tp)
        out[f"{name}/prefill_logits"] = logits.numpy()
        steps = []
        for tok in z[f"{name}/tokens"]:
            logits, cache = serve_step(model, shard_batch(torch.from_numpy(tok), mesh, rank),
                                       cache, tp=tp)
            steps.append(logits.numpy())
        out[f"{name}/step_logits"] = np.stack(steps)
        for k, v in cache.items():
            if torch.is_tensor(v):
                out[f"{name}/cache/{k}"] = v.numpy()


def train(model, mesh, rank, comm, z, name, out):
    tp = mesh.shape["model"]
    tok, lab = (shard_batch(torch.from_numpy(a), mesh, rank) for a in z[f"{name}/batch"])
    loss = lm_loss(model, tok, lab, tp=tp)
    specs = [model.shard.specs[n] for n, _ in model.named_parameters()]
    grads = _sharded_grads(comm, specs, torch.autograd.grad(loss, tuple(model.parameters())))
    grads = [gather_whole(g, s, comm) for g, s in zip(grads, specs)]
    out[f"{name}/loss"] = float(loss.detach())
    if rank == 0:
        for pname, g in zip(param_names(model.cfg, tp), grads):
            out[f"{name}/grad/{pname}"] = g.numpy()


def layer(model, mesh, rank, z, name, out):
    moe = model.layers[0].moe
    seen = []
    orig = MoE._straddling_routing

    def recording(self, *a):
        r, groups = orig(self, *a)
        seen.append(r)
        return r, groups

    rows = lambda a: torch.from_numpy(a).narrow(0, mesh.coords(rank)[0], 1)  # one row a data rank
    MoE._straddling_routing = recording
    try:
        x = rows(z[f"{name}/x"]).requires_grad_(True)
        y, aux = moe(x)
        cot = rows(z[f"{name}/cot"])
        dx, drouter = torch.autograd.grad((y * cot).sum() + aux, (x, moe.router))
    finally:
        MoE._straddling_routing = orig
    out[f"{name}/out"], out[f"{name}/aux"] = y.detach().numpy(), float(aux)
    out[f"{name}/dx"], out[f"{name}/drouter"] = dx.numpy(), drouter.numpy()
    for f in ("expert", "slot", "keep"):
        out[f"{name}/routing/{f}"] = getattr(seen[0], f)[0].numpy()


def main(work: str) -> int:
    torch.set_num_threads(1)
    world = MultihostContext.from_env()
    r = world.rank
    comms = {spec: MeshComm(make_mesh(spec), r, world) for spec in ("2x2", "1x4")}
    out: dict = {}
    with np.load(os.path.join(work, "inputs.npz")) as z:
        whole = {c: lm_params_from_reference(tree(z, f"params/{c}"), config(c), tp=tp_of(c))
                 for c in CONFIGS}
        for name, (cname, kind, _) in CASES.items():
            comm = comms[CONFIGS[cname][2]]
            comm.reset_stats()
            model = shard_model(whole[cname], comm.mesh, r, comm)
            if kind == "serve":
                serve(model, comm.mesh, r, z, name, out)
            elif kind == "train":
                train(model, comm.mesh, r, comm, z, name, out)
            else:
                layer(model, comm.mesh, r, z, name, out)
            out[f"{name}/collectives"] = np.array(repr(comm.summary()))
        exchange(world, comms, work, out)
    np.savez(os.path.join(work, f"rank{r}.npz"), **out)
    world.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
