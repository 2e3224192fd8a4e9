"""SBV GP fitting driver: the paper's main entry point.

    PYTHONPATH=src python -m repro_torch.launch.fit_gp --n 20000 --d 10 \
        --blocks 400 --m 60 --workers 1 --dataset synthetic

The counterpart of ``repro.launch.fit_gp``, with its flags and its
``[fit_gp]`` lines. Runs on the current CUDA device unless ``--device``
names another (``--device cpu`` on a machine without a GPU; without a CUDA
device and without ``--device`` it raises).

Datasets: synthetic (paper §6.1), satdrag (§6.2-like), metarvm (§6.3-like).
``--workers k`` runs the in-process distributed likelihood over a k-worker
mesh (``launch.mesh.make_worker_mesh``): the visible CUDA devices repeated
to k, or k workers on the ``--device`` CPU.

Out of core: ``--store DIR`` fits straight from an ``ArrayStore``
directory; ``--write-store DIR`` generates the synthetic dataset chunk by
chunk into a store first (then fits from it), and ``--stream-chunk``
bounds the rows held on the host per pass.

Multi-process: ``--distributed-hosts K`` re-launches this driver as K rank
processes (fresh interpreters) joined in a gloo process group
(``repro_torch.multihost``): each rank owns one partition of the store,
builds its share of the block structure (k-means all-reduce + halo NNS
exchange), spools only its own pieces, and joins the others in a lockstep
per-chunk loss/grad all-reduce. Ranks on a CUDA device share it. The
parent merges the per-rank ``--result-json`` files; each rank's file
carries its kernel launch counts, which only the rank can count.
``--timeout`` bounds each rank and each rendezvous or collective.

``--autotune`` and ``--tuning-record`` are not ported yet (ROADMAP queue 1
item 11).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def load_dataset(name: str, n: int, seed: int, outputs: int = 1):
    from repro_torch.data.gp_sim import (metarvm_dataset, metarvm_field_dataset,
                                         paper_synthetic, satellite_drag_like)

    if outputs > 1:
        if name != "metarvm":
            raise SystemExit("--outputs > 1 requires --dataset metarvm "
                             "(the multi-output field variant)")
        return metarvm_field_dataset(seed, n, p=outputs)
    if name == "synthetic":
        x, y, _ = paper_synthetic(seed, n)
        return x, y
    if name == "satdrag":
        return satellite_drag_like(seed, n)
    if name == "metarvm":
        return metarvm_dataset(seed, n)
    raise ValueError(name)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "satdrag", "metarvm"])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--outputs", type=int, default=1, metavar="P",
                    help="emulate P outputs jointly through the shared-structure "
                         "multi-output fit; metarvm only")
    ap.add_argument("--blocks", type=int, default=400)
    ap.add_argument("--m", type=int, default=60)
    ap.add_argument("--m-pred", type=int, default=120)
    ap.add_argument("--workers", type=int, default=1,
                    help="in-process distributed likelihood over a k-worker mesh")
    ap.add_argument("--inner-steps", type=int, default=40)
    ap.add_argument("--outer-rounds", type=int, default=2)
    ap.add_argument("--backend", default="auto", choices=["auto", "ref"],
                    help="auto: the kernels on CUDA (their plain versions on the CPU); "
                         "ref: the plain versions, differentiated directly")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--test-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="fit from an existing ArrayStore directory "
                         "(out-of-core; --n/--dataset are ignored)")
    ap.add_argument("--write-store", default=None, metavar="DIR",
                    help="generate the dataset chunk by chunk into a new store at DIR, "
                         "then fit from it")
    ap.add_argument("--stream-chunk", type=int, default=None,
                    help="max dataset rows held on host per streaming pass "
                         "(implies the out-of-core fit path)")
    ap.add_argument("--device-cache-mb", type=float, default=None,
                    help="device memory (MB) for the streaming fit's device-resident "
                         "spool tier; default sizes it from free device memory, 0 disables")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="disk-tier spool pieces staged ahead of the device by the copy "
                         "thread (0 = synchronous reads)")
    ap.add_argument("--precision", default=None, choices=["bf16", "f32", "f64"],
                    help="covariance-assembly ladder tier; in-core fits probe per bucket "
                         "and demote rungs that exceed the tier's error budget")
    ap.add_argument("--autotune", action="store_true",
                    help="not ported yet (ROADMAP queue 1 item 11)")
    ap.add_argument("--tuning-record", default=None, metavar="PATH",
                    help="not ported yet (ROADMAP queue 1 item 11)")
    ap.add_argument("--distributed-hosts", type=int, default=0, metavar="K",
                    help="spawn K rank processes in a gloo process group and run the "
                         "multi-host streaming fit (requires --store/--write-store)")
    ap.add_argument("--timeout", type=float, default=3600.0, metavar="SECONDS",
                    help="with --distributed-hosts: each rank's wall-clock limit and "
                         "the rendezvous and collective timeout")
    ap.add_argument("--result-json", default=None, metavar="PATH",
                    help="write the run summary as JSON (rank processes write "
                         "PATH.rank<r>; the parent merges them)")
    return ap


def write_store(args):
    """Chunked synthetic generation into a store (bounded RAM)."""
    from repro_torch.data.store import ArrayStore

    # The synthetic dataset is a GP draw, so its chunks come from one shared
    # function realization; satdrag/metarvm simulate x, so re-seeding their
    # sampling per chunk is sound.
    gen_rows = 65536
    if args.dataset == "synthetic":
        from repro_torch.data.gp_sim import paper_synthetic_chunks

        chunks = paper_synthetic_chunks(args.seed, args.n, gen_rows=gen_rows)
    else:
        def _sim_chunks():
            done, part = 0, 0
            while done < args.n:
                k = min(args.n - done, gen_rows)
                yield load_dataset(args.dataset, k, args.seed + part)
                done += k
                part += 1

        chunks = _sim_chunks()
    first_x, first_y = next(chunks)
    with ArrayStore.create(args.write_store, first_x.shape[1]) as w:
        w.append(first_x, first_y)
        for xp, yp in chunks:
            w.append(xp, yp)
    store = ArrayStore(args.write_store)
    print(f"[fit_gp] wrote store {args.write_store}: "
          f"{store.n_rows} rows x {store.d} dims, {store.n_shards} shards")
    return store


# -- multi-host launch ------------------------------------------------------


def _spawn_hosts(args) -> dict:
    """Parent mode: launch K rank copies of this driver and merge results.

    The parent prepares the store, builds the kernels once when the ranks
    will run on a CUDA device, hosts the ranks' rendezvous store and waits
    for them; a failed rank fails the run."""
    from repro_torch.device import resolve_device
    from repro_torch.multihost import spawn_ranks

    if args.write_store:
        write_store(args)
        store_dir = args.write_store
    elif args.store:
        store_dir = args.store
    else:
        raise SystemExit("--distributed-hosts requires --store or --write-store "
                         "(ranks share one store directory)")
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build()

    k = int(args.distributed_hosts)
    child = [sys.executable, "-m", "repro_torch.launch.fit_gp", "--store", store_dir,
             "--blocks", args.blocks, "--m", args.m, "--inner-steps", args.inner_steps,
             "--outer-rounds", args.outer_rounds, "--backend", args.backend,
             "--seed", args.seed, "--prefetch", args.prefetch]
    for flag, val in (("--stream-chunk", args.stream_chunk), ("--precision", args.precision),
                      ("--device-cache-mb", args.device_cache_mb), ("--device", args.device),
                      ("--result-json", args.result_json)):
        if val is not None:
            child += [flag, val]
    t0 = time.time()
    results = spawn_ranks(child, k, timeout_s=args.timeout)
    failed = False
    for r, (code, text) in enumerate(results):
        for line in text.splitlines():
            print(f"[rank {r}] {line}")
        if code != 0:
            print(f"[fit_gp] rank {r} exited with {code}")
            failed = True
    if failed:
        raise SystemExit("multi-host fit failed: see rank logs above")
    print(f"[fit_gp] {k} ranks finished in {time.time() - t0:.1f}s")

    merged = None
    if args.result_json:
        ranks = []
        for r in range(k):
            with open(f"{args.result_json}.rank{r}") as f:
                ranks.append(json.load(f))
        nlls = [rk["nll"] for rk in ranks]
        merged = {"n_hosts": k, "nll": nlls[0],
                  "max_nll_spread": float(max(nlls) - min(nlls)), "ranks": ranks}
        with open(args.result_json, "w") as f:
            json.dump(merged, f, indent=1)
        print(f"[fit_gp] merged {k} rank results -> {args.result_json} "
              f"(nll={nlls[0]:.9f}, spread={merged['max_nll_spread']:.3g})")
    return merged or {"n_hosts": k}


def _warm_up(dev, d: int) -> None:
    """One small likelihood value and gradient on ``dev``, so the CUDA
    context, the kernel library and the linear-algebra libraries are
    loaded before a fit's memory is sampled; the launch counts are then
    reset."""
    import torch

    from repro_torch.core.fit import _chunk_grad
    from repro_torch.core.kernels_math import KernelParams
    from repro_torch.core.pipeline import SBVConfig, preprocess
    from repro_torch.core.vecchia import packed_arrays
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    packed, _ = preprocess(rng.uniform(size=(64, d)), rng.normal(size=64), np.full(d, 0.5),
                           SBVConfig(n_blocks=8, m=8))
    params = KernelParams(*(torch.as_tensor(a).to(dev) for a in
                            KernelParams.create(sigma2=1.0, beta=0.5, nugget=1e-3, d=d)))
    _chunk_grad(params, packed_arrays(packed, dev), 3.5, "auto", 64)
    ops.reset_launch_counts()


def _run_rank(ctx, args) -> dict:
    """Child mode: one rank of the multi-host streaming fit.

    Ranks fit only and report their partition telemetry, peak RSS beside
    the working-set model's host terms, and their kernel launches."""
    from repro_torch.core.fit import fit_sbv
    from repro_torch.core.pipeline import SBVConfig
    from repro_torch.data.store import ArrayStore
    from repro_torch.data.streaming import working_set_model
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.memwatch import PeakRssSampler

    if not args.store:
        raise SystemExit("rank processes need --store")
    dev = resolve_device(args.device)
    store = ArrayStore(args.store)
    cfg = SBVConfig(n_blocks=args.blocks, m=args.m, seed=args.seed)
    device_cache = (None if args.device_cache_mb is None
                    else int(args.device_cache_mb * 2**20))
    _warm_up(dev, store.d)

    sampler = PeakRssSampler().start()
    t0 = time.time()
    res = fit_sbv(store, None, cfg, inner_steps=args.inner_steps,
                  outer_rounds=args.outer_rounds, backend=args.backend,
                  stream_chunk=args.stream_chunk, verbose=True, device=dev,
                  device_cache=device_cache, prefetch=args.prefetch,
                  multihost=ctx, precision=args.precision)
    t_fit = time.time() - t0
    peak = sampler.stop()

    st = res.stream_stats
    ws = working_set_model(st, store.n_rows, store.d, args.m,
                           args.stream_chunk or store.n_rows, device=dev)
    step_s = st["inner_time_s"] / max(st["inner_steps_total"], 1)
    out = {
        "rank": ctx.rank, "n_hosts": ctx.size, "device": str(dev),
        "nll": float(res.history[-1][2]), "t_fit_s": t_fit, "step_s": step_s,
        "sigma2": float(res.params.sigma2),
        "beta": res.params.beta.detach().cpu().numpy().tolist(),
        "nugget": float(res.params.nugget),
        "peak_rss_bytes": peak,
        "working_set_bytes": int(ws["total"]),
        "working_set_terms": ws["terms"],
        "launches": ops.launch_counts(),
        "allreduce_s": ctx.allreduce_s,
        "stats": {key: v for key, v in st.items()
                  if isinstance(v, (int, float, str, bool))},
    }
    print(f"[fit_gp] rank {ctx.rank}/{ctx.size}: nll={out['nll']:.9f} "
          f"fit {t_fit:.1f}s ({step_s:.3f}s per step), owned {st.get('owned_rows')}/"
          f"{store.n_rows} rows (+{st.get('halo_rows', 0)} halo), exchange "
          f"{st.get('exchange_bytes', 0) / 2**20:.1f}MB in {st.get('exchange_s', 0.0):.2f}s")
    if args.result_json:
        with open(f"{args.result_json}.rank{ctx.rank}", "w") as f:
            json.dump(out, f, indent=1)
    ctx.shutdown()
    return out


def main(argv=None):
    from repro_torch.multihost import MultihostContext

    args = build_parser().parse_args(argv)
    if args.autotune or args.tuning_record:
        raise NotImplementedError("--autotune / --tuning-record: autotuning is not ported "
                                  "yet (ROADMAP queue 1 item 11)")
    if args.outputs > 1 and (args.store or args.write_store or args.distributed_hosts):
        raise SystemExit("--outputs > 1 runs the in-core multi-output fit; combine it with "
                         "--stream-chunk for the streaming path, not "
                         "--store/--write-store/--distributed-hosts")
    ctx = MultihostContext.from_env()
    if ctx is not None:
        return _run_rank(ctx, args), None
    if args.distributed_hosts and args.distributed_hosts > 1:
        return _spawn_hosts(args), None

    from repro_torch.core.fit import fit_sbv
    from repro_torch.core.pipeline import SBVConfig
    from repro_torch.core.predict import predict_sbv
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_worker_mesh

    dev = resolve_device(args.device)
    distributed = None
    if args.workers > 1:
        mesh = make_worker_mesh(args.workers, devices=None if dev.type == "cuda" else dev)
        distributed = (mesh, "workers")
    cfg = SBVConfig(n_blocks=args.blocks, m=args.m, n_workers=args.workers, seed=args.seed)

    store = None
    if args.store:
        from repro_torch.data.store import ArrayStore

        store = ArrayStore(args.store)
    elif args.write_store:
        store = write_store(args)

    if store is not None:
        rng = np.random.default_rng(args.seed + 999)
        # Probe set: a bounded random row sample. The streaming fit trains
        # on every row, so this MSPE is in-sample: a surrogate sanity check.
        n_test = min(5000, max(1, int(store.n_rows * args.test_frac)))
        x_te, y_te = store.read_rows(rng.choice(store.n_rows, size=n_test, replace=False))
        y_te_c = y_te
        mu_y = 0.0
        device_cache = (None if args.device_cache_mb is None
                        else int(args.device_cache_mb * 2**20))
        t0 = time.time()
        res = fit_sbv(store, None, cfg, inner_steps=args.inner_steps,
                      outer_rounds=args.outer_rounds, backend=args.backend,
                      stream_chunk=args.stream_chunk, verbose=True, device=dev,
                      distributed=distributed, device_cache=device_cache,
                      prefetch=args.prefetch, precision=args.precision)
        t_fit = time.time() - t0
        beta = res.params.beta.detach().cpu().numpy()
        st = res.stream_stats
        print(f"[fit_gp] streaming fit {store.n_rows} pts in {t_fit:.1f}s "
              f"({st['n_chunks']} chunks/round, "
              f"{st['device_cached_pieces']}/{st['n_pieces']} pieces "
              f"device-cached, {st['h2d_bytes_per_step'] / 2**20:.1f}MB "
              f"H2D/step); sigma2={float(res.params.sigma2):.4f}")
        print("[fit_gp] relevance 1/beta:", np.round(1.0 / beta, 3))

        t0 = time.time()
        pred = predict_sbv(res.params, store, None, x_te, bs_pred=5, m_pred=args.m_pred,
                           chunk_size=4096, stream_chunk=args.stream_chunk, device=dev)
        t_pred = time.time() - t0
    else:
        x, y = load_dataset(args.dataset, args.n, args.seed, outputs=args.outputs)
        n_test = int(y.shape[0] * args.test_frac)
        x_tr, y_tr = x[:-n_test], y[:-n_test]
        x_te, y_te = x[-n_test:], y[-n_test:]
        mu_y = y_tr.mean(axis=0)  # per-output centering (scalar when 1-D)
        y_tr_c, y_te_c = y_tr - mu_y, y_te - mu_y

        t0 = time.time()
        res = fit_sbv(x_tr, y_tr_c, cfg, inner_steps=args.inner_steps,
                      outer_rounds=args.outer_rounds, backend=args.backend,
                      distributed=distributed, verbose=True, device=dev,
                      stream_chunk=args.stream_chunk, precision=args.precision)
        t_fit = time.time() - t0
        beta = res.params.beta.detach().cpu().numpy()
        sigma2 = res.params.sigma2.detach().cpu().numpy()
        if sigma2.ndim:  # multi-output: per-output vectors
            print(f"[fit_gp] fit {len(y_tr)} pts x {sigma2.size} outputs in "
                  f"{t_fit:.1f}s; sigma2={np.round(sigma2, 4)} "
                  f"tau2={float(res.params.tau2):.2e}")
        else:
            print(f"[fit_gp] fit {len(y_tr)} pts in {t_fit:.1f}s; "
                  f"sigma2={float(sigma2):.4f} nugget={float(res.params.nugget):.2e}")
        print("[fit_gp] relevance 1/beta:", np.round(1.0 / beta, 3))

        t0 = time.time()
        pred = predict_sbv(res.params, x_tr, y_tr_c, x_te, bs_pred=5, m_pred=args.m_pred,
                           device=dev)
        t_pred = time.time() - t0
    mspe = float(np.mean((pred.mean - y_te_c) ** 2))
    denom = np.where(np.abs(y_te) > 1e-8, y_te, 1.0)
    rmspe = float(np.sqrt(np.mean(((pred.mean + mu_y - y_te) / denom) ** 2))) * 100
    cover = float(np.mean((y_te_c >= pred.ci_low) & (y_te_c <= pred.ci_high))) * 100
    print(f"[fit_gp] predict {n_test} pts in {t_pred:.1f}s: "
          f"MSPE={mspe:.5f} RMSPE={rmspe:.2f}% CI95-coverage={cover:.1f}%")
    if args.result_json:
        payload = {"nll": float(res.history[-1][2]), "t_fit_s": t_fit,
                   "t_predict_s": t_pred, "mspe": mspe, "rmspe_pct": rmspe,
                   "sigma2": res.params.sigma2.detach().cpu().numpy().tolist(),
                   "beta": beta.tolist(),
                   "nugget": res.params.nugget.detach().cpu().numpy().tolist()}
        with open(args.result_json, "w") as f:
            json.dump(payload, f, indent=1)
    return res, mspe


if __name__ == "__main__":
    main()
