"""LM training driver: the train step, the token stream and checkpoint /
restart on one device. The counterpart of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --steps 20 --ckpt-dir /tmp/ck --ckpt-every 10 --device cpu

It takes the reference's flags and prints its lines. ``--device`` (default
``cuda``) names the device; without a CUDA device it raises unless given
``--device cpu``: it never falls back to the CPU. ``--mesh DxM`` (or PxDxM)
trains the reference's layout on the one device at tp = M (an MoE's experts
padded to a multiple of M, the only thing a mesh changes in the reference's
training numbers); a ``[mesh]`` line prints tp, the padded experts and what
each device of that mesh would hold under the sharding rules (params,
grads and Adam moments).

``--mesh DxM --sharded`` splits the state instead: this program starts
D x M rank processes (``multihost.spawn_ranks``; ``--timeout`` bounds the
rendezvous and the run), or joins as one of them when the
``REPRO_TORCH_DIST_*`` environment names its rank. Each rank draws its
shards of the same seed-0 weights (``sharding.placement.init_shards``: one
layer whole at a time, never the whole model), keeps them and their Adam
moments on ``--device`` and runs ``make_train_step(..., comm=)`` on its
rows of each global batch; ranks on one CUDA device share it. Each rank's
``[mesh]`` line prints the bytes of its shards beside ``launch.dryrun``'s
reckoning for that mesh. Every stack shards: dense and MoE attention
stacks (an MoE's experts over 'model'; its dispatch groups must not
straddle the data split) and the recurrent stacks, zamba2 and rwkv6 (their
scans in the reference's ``FULL_BATCH`` layout: rows over every axis, every
head, through an all-to-all over 'model'). Rank 0
writes checkpoints of the gathered state in the format below, so a sharded
run's checkpoint resumes in a whole run, the reference or another mesh; a
resume cuts the loaded whole state into shards. (No SIGTERM save in a
sharded run: its gather would need every rank.)

The weights are drawn from a ``torch.Generator`` seeded 0 on the device, at
the reference's distributions (``models.model.init_params``); the draws are
the port's own, not JAX's, so the same seed does not give the reference's
weights. The data is ``TokenStream(seed=17)``, bitwise the reference's.
Checkpoints go through ``repro_torch.ckpt`` in the reference's key layout
(``params.*``, ``opt.mu.*``, ``opt.nu.*``, ``opt.step``, ``step``, per-layer
leaves stacked on a leading L axis; ``convert.reference_tree``) with the
stream's position in the manifest's extras, so a checkpoint saved by either
package resumes in the other.

``main(argv, log=None)`` returns the final ``TrainState``; a ``log`` list
receives one dict per step (step, loss, grad_norm, seconds; the step is
waited for).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, restore_train_state
from repro_torch.ckpt.checkpoint import latest_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import param_names, reference_tree, tensors_from_reference_tree
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import mesh_line
from repro_torch.models.model import TransformerLM, init_params
from repro_torch.optim import AdamState
from repro_torch.sharding.rules import tp_size
from repro_torch.training.train_step import TrainState, make_train_step, train_state_init


def checkpoint_tree(state: TrainState, names) -> dict:
    """``state`` in the reference's checkpoint layout (torch tensors, dtype
    kept; step counts as int32)."""
    tree = lambda ts: reference_tree(names, ts)
    return {"params": tree(state.params),
            "opt": {"step": np.int32(state.opt.step), "mu": tree(state.opt.mu),
                    "nu": tree(state.opt.nu)},
            "step": np.int32(state.step)}


def restore_state(path: str, state: TrainState, names, device) -> tuple[TrainState, dict]:
    """The checkpoint at ``path`` as a ``TrainState`` shaped like ``state``
    (each leaf at its dtype, on ``device``), and the manifest."""
    tree, manifest = restore_train_state(path, checkpoint_tree(state, names), device=device)
    leaves = lambda t: tuple(x.contiguous() for x in tensors_from_reference_tree(names, t))
    opt = AdamState(step=int(tree["opt"]["step"]), mu=leaves(tree["opt"]["mu"]),
                    nu=leaves(tree["opt"]["nu"]))
    return TrainState(params=leaves(tree["params"]), opt=opt, step=int(tree["step"])), manifest


def whole_template(cfg, tp: int = 1) -> TrainState:
    """A ``TrainState`` of whole leaves on ``meta`` (the checkpoint's
    structure and dtypes, an MoE's experts padded for ``tp``; no storage)."""
    params = tuple(p.detach() for p in TransformerLM(cfg, device="meta", tp=tp).parameters())
    f32 = tuple(torch.empty(p.shape, dtype=torch.float32, device="meta") for p in params)
    return TrainState(params=params, opt=AdamState(step=0, mu=f32, nu=f32), step=0)


def shard_state(state: TrainState, cfg, mesh, rank: int, device) -> TrainState:
    """This rank's shards of a whole ``state`` (params and moments by the
    params' specs), on ``device``."""
    from repro_torch.sharding.placement import shard_tensors

    skel = TransformerLM(cfg, device="meta", tp=tp_size(mesh))
    cut = lambda ts: tuple(t.to(device) for t in shard_tensors(skel, ts, mesh, rank))
    return TrainState(params=cut(state.params),
                      opt=AdamState(step=state.opt.step, mu=cut(state.opt.mu),
                                    nu=cut(state.opt.nu)),
                      step=state.step)


def gather_state(state: TrainState, cfg, comm) -> TrainState:
    """The whole state from every rank's shards, on every rank (collective)."""
    from repro_torch.sharding.placement import gather_whole, parameter_specs

    specs = list(parameter_specs(TransformerLM(cfg, device="meta", tp=tp_size(comm.mesh)),
                                 comm.mesh).values())
    whole = lambda ts: tuple(gather_whole(t, spec, comm) for t, spec in zip(ts, specs))
    return TrainState(params=whole(state.params),
                      opt=AdamState(step=state.opt.step, mu=whole(state.opt.mu),
                                    nu=whole(state.opt.nu)),
                      step=state.step)


def sharded_mesh_line(cfg, mesh, rank: int, measured: dict, shape) -> str:
    """A rank's ``[mesh]`` line: the bytes of its shards (``measured``:
    ``params``, and ``state`` for training, ``cache`` for serving) beside
    ``launch.dryrun.lm_cell_bytes`` for ``shape`` on ``mesh``."""
    from repro_torch.launch.dryrun import lm_cell_bytes

    rec = lm_cell_bytes(cfg, shape, mesh)
    want = {"params": rec["param_bytes"], "state": rec.get("adam_state_bytes"),
            "cache": rec["cache_bytes"]}
    coords = ", ".join(f"{a}={i}" for a, i in zip(mesh.axis_names, mesh.coords(rank)))
    parts = [f"{key} {measured[key]:,} B (dry run {want[key]:,} B)" for key in measured]
    return f"[mesh] {mesh} rank {rank} ({coords}), sharded: " + "; ".join(parts)


def configure(cfg, reduced: bool, overrides: list):
    """``cfg`` (reduced with ``reduced``) with the ``--override field=value``
    strings applied, each value of its field's type."""
    over = {}
    for kv in overrides:
        k, v = kv.split("=", 1)
        over[k] = type(getattr(cfg, k))(v) if not isinstance(getattr(cfg, k), bool) else v == "True"
    if reduced:
        return cfg.reduced(**over)
    return dataclasses.replace(cfg, **over) if over else cfg


def launch_ranks(module: str, argv: list, mesh, timeout_s: float) -> list:
    """Run ``python -m module argv`` as the mesh's rank processes, print
    each rank's output, and raise if one failed: ``[(rc, output), ...]``."""
    from repro_torch.multihost import spawn_ranks

    results = spawn_ranks([sys.executable, "-m", module, *argv], mesh.size, timeout_s)
    for r, (rc, out) in enumerate(results):
        for line in out.splitlines():
            print(f"[rank {r}] {line}")
    bad = [r for r, (rc, _) in enumerate(results) if rc != 0]
    if bad:
        raise RuntimeError(f"{module} --sharded: ranks {bad} failed (exit codes "
                           f"{[results[r][0] for r in bad]})")
    return results


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, log: list | None = None) -> TrainState | None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", help="CPU-size config")
    ap.add_argument("--override", action="append", default=[],
                    help="config field override, e.g. --override n_layers=12")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; without a GPU pass --device cpu)")
    ap.add_argument("--sharded", action="store_true",
                    help="split the state over the mesh's rank processes")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="--sharded: seconds for the rendezvous and the ranks' run")
    args = ap.parse_args(argv)

    mesh = make_mesh(args.mesh)
    tp = tp_size(mesh)
    comm = None
    if args.sharded:
        from repro_torch.sharding.collectives import MeshComm

        comm = MeshComm.from_env(mesh)
        if comm is None:
            launch_ranks("repro_torch.launch.train", argv, mesh, args.timeout)
            return None
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
    cfg = configure(get_config(args.arch), args.reduced, args.override)

    gen = torch.Generator(device=dev).manual_seed(0)
    if comm is None:
        model = init_params(cfg, gen, device=dev, tp=tp)
        print(mesh_line(cfg, mesh, model, train=True))
        state = train_state_init(model)
        del model
    else:
        from repro_torch.sharding.placement import init_shards

        state = train_state_init(init_shards(cfg, gen, mesh, comm.rank, dev))
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        p_bytes = nbytes(state.params)
        measured = {"params": p_bytes,
                    "state": 2 * p_bytes + nbytes(state.opt.mu) + nbytes(state.opt.nu)}
        from repro_torch.configs import ShapeSpec

        print(sharded_mesh_line(cfg, mesh, comm.rank, measured,
                                ShapeSpec("cli", args.seq, args.batch, "train")))
    names = param_names(cfg, tp)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=17)
    start_step = 0
    mgr = None
    writer = comm is None or comm.rank == 0
    whole = (lambda st: st) if comm is None else (lambda st: gather_state(st, cfg, comm))
    if args.ckpt_dir:
        if writer:
            mgr = CheckpointManager(args.ckpt_dir, keep=3, install_sigterm=comm is None)
        if args.resume:
            path = latest_checkpoint(args.ckpt_dir)
            if path:
                if comm is None:
                    state, manifest = restore_state(path, state, names, dev)
                else:
                    state, manifest = restore_state(path, whole_template(cfg, tp), names, "cpu")
                    state = shard_state(state, cfg, mesh, comm.rank, dev)
                stream.load_state_dict(manifest["extras"]["stream"])
                start_step = int(manifest["step"])
                print(f"[train] resumed from {path} at step {start_step}")

    def save(step, st, block=False):
        tree = checkpoint_tree(whole(st), names)
        if mgr:
            mgr.save(step, tree, {"stream": stream.state_dict()}, block=block)

    step_fn = make_train_step(cfg, tp=tp, lr=args.lr, grad_accum=args.grad_accum, comm=comm)
    snap = {"state": state, "step": start_step}
    if mgr and comm is None:
        # preemption-safe: SIGTERM triggers a final checkpoint
        mgr.register_state_provider(
            lambda: (snap["step"], checkpoint_tree(snap["state"], names),
                     {"stream": stream.state_dict()}))

    metrics = None
    try:
        t_last = time.time()
        for i in range(start_step, start_step + args.steps):
            t0 = time.perf_counter()
            tok, lab = stream.next()
            state, metrics = step_fn(state, tok, lab)
            snap = {"state": state, "step": i + 1}
            if log is not None:
                _sync(dev)
                log.append({"step": i + 1, "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": time.perf_counter() - t0})
            if (i + 1) % 10 == 0 or i == start_step:
                loss = float(metrics["loss"])
                dt = time.time() - t_last
                t_last = time.time()
                print(f"[train] step {i+1} loss {loss:.4f} ({dt:.2f}s)")
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save(i + 1, state)
        if args.ckpt_dir:
            save(start_step + args.steps, state, block=True)
    finally:
        if mgr:
            mgr.close()
            if comm is None:
                signal.signal(signal.SIGTERM, mgr._prev_handler)
    if metrics is not None:
        print("[train] done; final loss", float(metrics["loss"]))
    if comm is not None:
        print(f"[train] rank {comm.rank} collectives: {comm.summary()}")
        comm.shutdown()
    return state


if __name__ == "__main__":
    main()
