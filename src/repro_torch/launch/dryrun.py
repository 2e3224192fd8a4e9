"""Dry run: every (arch x shape x mesh) cell built and stepped on the
``meta`` device, with no storage and no launch. The counterpart of
``repro.launch.dryrun``.

For each cell it records the bytes one device of the mesh holds under the
cell's specs (``launch.specs``: parameters; for training, the gradients and
the functional Adam's f32 moments, 12 B a bf16 parameter, and the 22 B it
holds at the update, old and new side by side; the decode cache), whether
that peak fits one 80 GB card, the step's FLOPs as
``torch.utils.flop_counter.FlopCounterMode`` counts them over the step run
on ``meta`` (matrix products; the attention as the plain version's dense
products) beside ``analysis.model_flops``, and the reckoned roofline terms
for an H100 (``analysis.roofline``). Cells that ``configs.applicable``
rules out are recorded as skipped with its reason.

Deviation from the reference: the reference lowers and compiles each cell's
XLA program for 256 and 512 virtual devices and reads the compiler's
``memory_analysis`` and cost analysis. The port has no compiler to ask: it
reckons the bytes from its specs (no activations, no temporaries) and counts
FLOPs by dispatch, each step at one and two units of its repeating layers,
extended linearly to the config's depth (``lm_step_flops``; exact, as the
tests hold against full-depth counts). Meshes: ``pod`` (16 x 16),
``multipod`` (2 x 16 x 16) and ``1x1`` (one card, tp = 1). Cells whose
steps agree (the pod meshes share their tp, 16) are counted once;
``--jobs N`` counts the distinct steps in N forked processes first.

Usage:
    python -m repro_torch.launch.dryrun                       # all cells, all meshes
    python -m repro_torch.launch.dryrun --arch gemma2-9b      # one arch
    python -m repro_torch.launch.dryrun --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --out results.json --resume
    python -m repro_torch.launch.dryrun --jobs 6                # ~15 s on 8 cores
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
import traceback

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import CellReport, model_flops, roofline
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import (CELLS, SBV_GP_SHAPES, abstract_params, adam_bytes,
                                      build_cell, cache_bytes, meta_cache, param_bytes)
from repro_torch.models.transformer import padded_experts
from repro_torch.sharding.rules import tp_size

MESHES = {"pod": make_production_mesh(), "multipod": make_production_mesh(multi_pod=True),
          "1x1": make_mesh("1x1")}

_FLOPS: dict = {}  # (arch, shape, padded experts or device count) -> counted FLOPs


def count_flops(step, args) -> float:
    """FLOPs of one call of ``step(*args)`` on meta tensors."""
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return float(fc.get_total_flops())


def layer_period(cfg) -> int:
    """Layers of one repeating unit: a hybrid group, a local / global pair."""
    return cfg.attn_every or (2 if cfg.local_global else 1)


def lm_step_flops(cfg, shape, mesh, full: bool = False) -> float:
    """The cell's step FLOPs. Its units of ``layer_period`` layers are alike
    (on ``meta`` every attention is the plain version's dense products,
    whatever its window), so the count is linear in their number: the step
    is counted at one unit and at two and extended to the config's depth
    (``full``: counted at full depth instead)."""
    p = layer_period(cfg)
    if full or cfg.n_layers <= 2 * p:
        return count_flops(*CELLS[shape.kind](cfg, shape, mesh)[:2])
    f1, f2 = (count_flops(*CELLS[shape.kind](dataclasses.replace(cfg, n_layers=n), shape,
                                             mesh)[:2]) for n in (p, 2 * p))
    return f1 + (cfg.n_layers // p - 1) * (f2 - f1)


def sbv_gp_flops(shape_name: str) -> float:
    """The reference's analytic count: per block two Cholesky factors (m^3 /
    3, bs^3 / 3), a triangular solve (m^2 bs) and a product (m bs^2), x 2
    for the backward."""
    spec = SBV_GP_SHAPES[shape_name]
    m, bs = spec["m"], spec["bs"]
    bc = spec["n"] / bs
    return bc * (m ** 3 / 3 + bs ** 3 / 3 + m * m * bs + m * bs * bs) * 2.0


@functools.lru_cache(maxsize=None)
def _model_bytes(cfg, mesh) -> tuple:
    """(param bytes (total, per device), Adam bytes, dtype) of ``cfg`` built
    at the mesh's tp: one meta model per (config, mesh)."""
    model = abstract_params(cfg, tp_size(mesh))
    return param_bytes(model, mesh), adam_bytes(model, mesh), model.dtype


def lm_cell_bytes(cfg, shape, mesh) -> dict:
    """Bytes of an LM cell under its specs, per device and (``totals``) in
    all: params; for train the grads and Adam moments (``state_bytes``) and
    the 22 B-a-parameter update (the peak); for prefill and decode the
    cache of ``shape.seq_len`` slots."""
    (p_all, p_dev), ad, dtype = _model_bytes(cfg, mesh)
    if shape.kind == "train":
        return dict(param_bytes=p_dev, state_bytes=ad["state"][1] - p_dev, cache_bytes=0,
                    peak=ad["update"][1], totals=dict(params=p_all, adam_state=ad["state"][0],
                                                      adam_update=ad["update"][0]),
                    adam_update_bytes=ad["update"][1], adam_state_bytes=ad["state"][1])
    cache = meta_cache(cfg, shape.global_batch, shape.seq_len, tp_size(mesh), dtype)
    c_all, c_dev = cache_bytes(cache, mesh)
    return dict(param_bytes=p_dev, state_bytes=0, cache_bytes=c_dev, peak=p_dev + c_dev,
                totals=dict(params=p_all, cache=c_all))


def _flop_key(arch: str, shape_name: str, mesh) -> tuple:
    """Cells with one key share their step's FLOPs: tp changes an LM step's
    FLOPs only through the padded experts (the expanded cache repeats
    reads, not products); the SBV GP's blocks are padded to the device
    count."""
    if arch == "sbv-gp":
        return (arch, shape_name, mesh.size)
    return (arch, shape_name, padded_experts(get_config(arch), tp_size(mesh)))


def cell_flops(arch: str, shape_name: str, mesh_name: str) -> float:
    mesh = MESHES[mesh_name]
    if arch == "sbv-gp":
        return count_flops(*build_cell(arch, shape_name, mesh)[:2])
    return lm_step_flops(get_config(arch), SHAPES[shape_name], mesh)


def _cell_flops_or_none(cell: tuple):
    """``cell_flops`` in a worker process; None where it fails (the cell then
    counts again in the main process, which records the error)."""
    try:
        return cell_flops(*cell)
    except Exception:
        return None


def count_in_parallel(cells, jobs: int) -> None:
    """Fill ``_FLOPS`` for ``cells`` ((arch, shape, mesh name) triples) with
    ``jobs`` worker processes, one count per distinct key."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    todo = {}
    # the training steps first: they take longest to count
    for arch, sname, mname in sorted(cells, key=lambda c: c[1] != "train_4k"):
        key = _flop_key(arch, sname, MESHES[mname])
        if key not in _FLOPS:
            todo.setdefault(key, (arch, sname, mname))
    with ProcessPoolExecutor(jobs, mp_context=get_context("fork")) as ex:
        for key, flops in zip(todo, ex.map(_cell_flops_or_none, todo.values())):
            if flops is not None:
                _FLOPS[key] = flops


def run_cell(arch: str, shape_name: str, mesh_name: str, verbose: bool = True) -> dict:
    mesh = MESHES[mesh_name]
    t0 = time.perf_counter()
    step, args, _ = build_cell(arch, shape_name, mesh)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    if arch == "sbv-gp":
        blocks = args[1:]
        dev = sum(t.numel() * t.element_size() for t in blocks) // mesh.size
        by = dict(param_bytes=0, state_bytes=dev, cache_bytes=0, peak=dev,
                  totals=dict(blocks=dev * mesh.size))
        mflops = sbv_gp_flops(shape_name)
    else:
        by = lm_cell_bytes(get_config(arch), SHAPES[shape_name], mesh)
        mflops = model_flops(get_config(arch), SHAPES[shape_name])
    key = _flop_key(arch, shape_name, mesh)
    if key not in _FLOPS:
        _FLOPS[key] = cell_flops(arch, shape_name, mesh_name)
    t_count = time.perf_counter() - t0
    rep = CellReport(arch=arch, shape=shape_name, mesh=mesh_name, n_devices=mesh.size,
                     flops=_FLOPS[key], param_bytes=by["param_bytes"],
                     state_bytes=by["state_bytes"], cache_bytes=by["cache_bytes"],
                     peak_memory=by["peak"], model_flops=mflops)
    rep.extra = {"t_build_s": t_build, "t_count_s": t_count, "totals": by["totals"],
                 "tp": tp_size(mesh), **{k: by[k] for k in ("adam_state_bytes",
                                                            "adam_update_bytes") if k in by}}
    if verbose:
        gib = lambda b: f"{b / 2**30:.2f}"
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK (build {t_build:.2f}s count "
              f"{t_count:.2f}s) peak {gib(rep.peak_memory)} GiB/dev (params "
              f"{gib(rep.param_bytes)} + state {gib(rep.state_bytes)} + cache "
              f"{gib(rep.cache_bytes)}); fits 80 GB: {'yes' if rep.fits else 'no'}")
        print("         " + roofline(rep))
    return rep.to_dict()


def all_cells(archs=None, shapes=None, meshes=None):
    archs = archs or (list(ARCHS) + ["sbv-gp"])
    meshes = meshes or list(MESHES)
    for arch in archs:
        if arch == "sbv-gp":
            snames = [s for s in (shapes or list(SBV_GP_SHAPES)) if s in SBV_GP_SHAPES]
        else:
            snames = [s for s in (shapes or list(SHAPES)) if s in SHAPES]
        for sname in snames:
            if arch != "sbv-gp":
                ok, why = applicable(get_config(arch), sname)
                if not ok:
                    yield (arch, sname, None, {"skipped": why})
                    continue
            for mname in meshes:
                yield (arch, sname, mname, None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", action="append", default=None, choices=list(MESHES))
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes that count the steps' FLOPs")
    args = ap.parse_args(argv)

    results = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    failures = []
    t_all = time.perf_counter()
    cells = list(all_cells(args.arch, args.shape, args.mesh))
    if args.jobs > 1:
        count_in_parallel([(a, s, m) for a, s, m, skip in cells if skip is None
                           and not (args.resume and "error" not in
                                    results.get(f"{a}|{s}|{m}", {"error": 1}))], args.jobs)
    for arch, sname, mname, skip in cells:
        if skip is not None:
            key = f"{arch}|{sname}|-"
            results[key] = {"arch": arch, "shape": sname, **skip}
            print(f"[dryrun] {arch} x {sname}: SKIP ({skip['skipped'][:60]}...)")
            continue
        key = f"{arch}|{sname}|{mname}"
        if args.resume and key in results and "error" not in results[key]:
            continue
        try:
            results[key] = run_cell(arch, sname, mname)
        except Exception as e:
            traceback.print_exc()
            results[key] = {"arch": arch, "shape": sname, "mesh": mname,
                            "error": f"{type(e).__name__}: {e}"}
            failures.append(key)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(1 for v in results.values() if "error" not in v and "skipped" not in v)
    n_skip = sum(1 for v in results.values() if "skipped" in v)
    print(f"\n[dryrun] {n_ok} cells OK, {n_skip} skipped, {len(failures)} FAILED -> {args.out} "
          f"({time.perf_counter() - t_all:.1f} s)")
    if failures:
        print("FAILED:", failures)
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
