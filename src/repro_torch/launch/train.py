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
grads and Adam moments). The tensors are not split over cards.

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
from repro_torch.models.model import init_params
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, log: list | None = None) -> TrainState:
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
    args = ap.parse_args(argv)

    mesh = make_mesh(args.mesh)
    tp = tp_size(mesh)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
    cfg = get_config(args.arch)
    over = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        over[k] = type(getattr(cfg, k))(v) if not isinstance(getattr(cfg, k), bool) else v == "True"
    if args.reduced:
        cfg = cfg.reduced(**over)
    elif over:
        cfg = dataclasses.replace(cfg, **over)

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, tp=tp)
    print(mesh_line(cfg, mesh, model, train=True))
    state = train_state_init(model)
    del model
    names = param_names(cfg, tp)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=17)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3, install_sigterm=True)
        if args.resume:
            path = latest_checkpoint(args.ckpt_dir)
            if path:
                state, manifest = restore_state(path, state, names, dev)
                stream.load_state_dict(manifest["extras"]["stream"])
                start_step = int(manifest["step"])
                print(f"[train] resumed from {path} at step {start_step}")

    step_fn = make_train_step(cfg, tp=tp, lr=args.lr, grad_accum=args.grad_accum)
    snap = {"state": state, "step": start_step}
    if mgr:
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
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, checkpoint_tree(state, names), {"stream": stream.state_dict()})
        if mgr:
            mgr.save(start_step + args.steps, checkpoint_tree(state, names),
                     {"stream": stream.state_dict()}, block=True)
    finally:
        if mgr:
            mgr.close()
            signal.signal(signal.SIGTERM, mgr._prev_handler)
    if metrics is not None:
        print("[train] done; final loss", float(metrics["loss"]))
    return state


if __name__ == "__main__":
    main()
