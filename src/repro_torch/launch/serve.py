"""Batched serving from the command line.

LM mode (default): prefill + greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --reduced --batch 2 --prompt-len 32 --max-new 8 --device cpu

GP mode: the persistent SBV prediction service (paper Eq. 3).

    PYTHONPATH=src python -m repro_torch.launch.serve gp --n-train 20000 \
        --n-test 100000 --chunk 4096 --bs-pred 25 --m-pred 120 --requests 64

The counterpart of ``repro.launch.serve``, with its flags, defaults and
prints. Runs on the current CUDA device unless ``--device`` names another
(``--device cpu`` on a machine without a GPU; without a CUDA device and
without ``--device`` it raises).

LM mode: weights are drawn from ``torch.Generator`` seed 0 on the device,
the prompt from ``np.random.default_rng(3)``, as there. ``--mesh DxM`` (or
PxDxM) runs the reference's layout on the one device it is given, at tp =
M: the MoE's experts padded to a multiple of M and the decode cache's KV
heads expanded to divide it, the only two things a mesh changes in the
reference's numbers. A ``[mesh]`` line prints tp, the padded experts, the
cache factor r and the bytes each device of that mesh would hold under the
sharding rules. ``--mesh DxM --sharded`` splits the weights and the cache
instead: D x M rank processes (started here through
``multihost.spawn_ranks``, or joined from the ``REPRO_TORCH_DIST_*``
environment) each hold their shards (``sharding.placement``), prefill
their rows of the prompt and decode on their block of the cache; the greedy
token comes from the logits gathered over 'model' and is the same on every
rank. Each rank's ``[mesh]`` line prints its shards' bytes beside
``launch.dryrun``'s reckoning. Only dense attention stacks shard.

GP mode: a ``GPServer`` builds the training index once and serves a
stream of asynchronous requests; the micro-batcher (or, with
``--scheduler continuous``, the continuous scheduler) feeds the
double-buffered chunk pipeline (the host packs chunk k+1 while the card
computes chunk k). ``--backend`` is ``auto`` (the predict kernel on CUDA,
its plain version on the CPU) or ``ref``; ``--tuning-record`` fills
``--buckets``, ``--stream-chunk``, ``--precision`` and ``--backend`` where
they are unset. ``--workers k`` shards every chunk's blocks over a k-worker
mesh (``launch.mesh.make_worker_mesh``). ``--replicas N`` fronts N
scheduler-mode servers (threads on one device, a CUDA stream each) with
the shape-affinity router. ``--distributed-hosts K`` re-launches this
program as K rank processes in a gloo process group
(``repro_torch.multihost``): each rank serves its rendezvous-owned slice
of the request stream through a local router, then the ranks together run
``predict_sbv(multihost=)`` against their serial prediction; ranks on a
CUDA device share it. ``--compare`` races the synchronous chunk loop
against the pipelined one on the same workload and checks their parity.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- GP mode ------------------------------------------------------------------


def _gp_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("serve gp")
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "satdrag", "metarvm"])
    ap.add_argument("--n-train", type=int, default=20_000)
    ap.add_argument("--outputs", type=int, default=1, metavar="P",
                    help="serve a P-output model (metarvm field variant): requests "
                         "carry an output mask and results are (n, P)")
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--bs-pred", type=int, default=25)
    ap.add_argument("--m-pred", type=int, default=120)
    ap.add_argument("--backend", default=None, choices=["auto", "ref"],
                    help="auto: the predict kernel on CUDA (its plain version on the "
                         "CPU); ref: the plain version (default auto, or the tuning "
                         "record's choice with --tuning-record)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"],
                    help="packed-array precision")
    ap.add_argument("--precision", default=None, choices=["bf16", "f32", "f64"],
                    help="covariance-assembly ladder tier; overrides --dtype")
    ap.add_argument("--tuning-record", default=None, metavar="PATH",
                    help="start pre-tuned from a persisted autotuner record "
                         "(checkpoint dir or tuning_record.json); fills "
                         "--buckets/--stream-chunk/--precision/--backend where those "
                         "flags are unset")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=32,
                    help="split the test set into this many concurrent requests")
    ap.add_argument("--max-points", type=int, default=None,
                    help="micro-batch dispatch threshold (default: --chunk)")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="max batching delay after the first queued request")
    ap.add_argument("--adaptive-wait", action="store_true",
                    help="scale the batching window within [0, max-wait-ms] from the "
                         "observed request inter-arrival EMA")
    ap.add_argument("--buckets", type=int, default=None,
                    help="bucket each chunk by size with this many geometric ceiling "
                         "levels per dimension; reports padding occupancy")
    ap.add_argument("--pipeline", default="double", choices=["double", "sync"],
                    help="drain mode's chunk loop: double = the stream engine (host packing "
                         "overlapped with device compute); sync = the synchronous loop")
    ap.add_argument("--scheduler", default="drain", choices=["drain", "continuous"],
                    help="continuous = running batch with SLO-aware admission at every "
                         "chunk boundary, cancellation, backpressure; drain = the "
                         "coalesce-and-drain micro-batcher")
    ap.add_argument("--slo", default="interactive", choices=["interactive", "bulk"],
                    help="SLO class of the generated request stream (--scheduler "
                         "continuous)")
    ap.add_argument("--queue-bound", type=int, default=None, metavar="POINTS",
                    help="bound the admission queue at this many queued points "
                         "(--scheduler continuous)")
    ap.add_argument("--spool-threshold", type=int, default=None, metavar="POINTS",
                    help="requests at least this large stream results to a disk spool "
                         "sink instead of RAM (--scheduler continuous)")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="front N server replicas (threads sharing one training index, "
                         "a CUDA stream each) with the shape-affinity router; implies "
                         "--scheduler continuous")
    ap.add_argument("--routing", default="affinity",
                    choices=["affinity", "random", "round_robin"],
                    help="replica routing policy (--replicas > 1)")
    ap.add_argument("--spill-points", type=int, default=None, metavar="PTS",
                    help="spill an affinity-routed request to the least loaded replica "
                         "when its preferred replica has more outstanding points")
    ap.add_argument("--distributed-hosts", type=int, default=0, metavar="K",
                    help="spawn K rank processes in a gloo process group: each serves "
                         "its rendezvous-owned request slice through a local router, "
                         "then all ranks run the multi-host predict_sbv(multihost=) "
                         "parity probe (synthetic dataset only)")
    ap.add_argument("--timeout", type=float, default=3600.0, metavar="SECONDS",
                    help="with --distributed-hosts: each rank's wall-clock limit and "
                         "the rendezvous and collective timeout")
    ap.add_argument("--result-json", default=None, metavar="PATH",
                    help="write the serve summary as JSON (rank processes write "
                         "PATH.rank<r>; the parent merges them)")
    ap.add_argument("--compare", action="store_true",
                    help="race sync vs double-buffered on the same workload and "
                         "cross-check parity against predict_sbv")
    ap.add_argument("--train-store", default=None, metavar="DIR",
                    help="serve from an on-disk ArrayStore training set (out-of-core "
                         "index); synthetic-generator params only")
    ap.add_argument("--stream-chunk", type=int, default=None,
                    help="rows per streaming-index pass (with --train-store)")
    return ap


def _spawn_serve_hosts(args, dev: torch.device) -> dict:
    """Parent mode: launch K rank copies of ``serve gp`` and merge results.

    The parent builds the kernels once when the ranks run on a CUDA device,
    hosts the ranks' rendezvous store, waits for them (a failed rank fails
    the run) and merges their ``--result-json`` files."""
    from repro_torch.multihost import spawn_ranks

    if args.dataset != "synthetic" or args.train_store:
        raise SystemExit("--distributed-hosts serves the in-core synthetic dataset "
                         "(ranks regenerate it deterministically)")
    if args.workers > 1 or args.outputs > 1:
        raise SystemExit("--distributed-hosts is exclusive with --workers and --outputs "
                         "(one device per rank)")
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()

    k = int(args.distributed_hosts)
    child = [sys.executable, "-m", "repro_torch.launch.serve", "gp",
             "--n-train", args.n_train, "--n-test", args.n_test, "--chunk", args.chunk,
             "--bs-pred", args.bs_pred, "--m-pred", args.m_pred,
             "--backend", args.backend, "--dtype", args.dtype, "--seed", args.seed,
             "--requests", args.requests, "--replicas", max(1, args.replicas),
             "--routing", args.routing, "--scheduler", "continuous", "--slo", args.slo]
    for flag, val in (("--precision", args.precision), ("--buckets", args.buckets),
                      ("--stream-chunk", args.stream_chunk),
                      ("--spill-points", args.spill_points), ("--device", args.device),
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
            print(f"[serve-gp] rank {r} exited with {code}")
            failed = True
    if failed:
        raise SystemExit("multi-host serve failed: see rank logs above")
    print(f"[serve-gp] {k} ranks finished in {time.time() - t0:.1f}s")

    merged = {"n_hosts": k}
    if args.result_json:
        ranks = []
        for r in range(k):
            with open(f"{args.result_json}.rank{r}") as f:
                ranks.append(json.load(f))
        merged = {
            "n_hosts": k,
            "n_requests": sum(rk["n_requests"] for rk in ranks),
            "n_points": sum(rk["n_points"] for rk in ranks),
            "multihost_parity_max": max(rk["multihost_parity_max"] for rk in ranks),
            "multihost_mean_var_max": max(rk["multihost_mean_var_max"] for rk in ranks),
            "multihost_sim_max": max(rk["multihost_sim_max"] for rk in ranks),
            "served_parity_max": max(rk["served_parity_max"] for rk in ranks),
            "ranks": ranks,
        }
        with open(args.result_json, "w") as f:
            json.dump(merged, f, indent=1)
        print(f"[serve-gp] merged {k} rank results -> {args.result_json} "
              f"(multihost parity={merged['multihost_parity_max']:.3g}, "
              f"served parity={merged['served_parity_max']:.3g})")
    return merged


def _serve_rank(ctx, args, params, x, y, x_test, cfg, dev: torch.device) -> dict:
    """Child mode: one rank of the multi-host serve plane.

    Each rank fronts its local replicas with a router and serves the slice
    of the request stream it owns by rendezvous hashing (every rank
    computes the same ownership table from the request index, with no
    coordination). Then every rank runs ``predict_sbv(multihost=ctx)`` over
    the FULL test set (blocks sharded by rank, one all-reduce) and checks it
    against its own serial ``predict_sbv``, and checks up to four of its
    served requests against their lone ``predict_sbv`` calls."""
    from repro_torch.core.predict import predict_sbv
    from repro_torch.kernels import ops
    from repro_torch.serving import GPServer, ReplicaRouter
    from repro_torch.serving.router import rendezvous_rank

    servers = [GPServer(params, x, y, cfg, device=dev)]
    servers += [GPServer(params, x, y, cfg, index=servers[0].index, device=dev)
                for _ in range(max(1, args.replicas) - 1)]
    router = ReplicaRouter(servers, routing=args.routing, spill_points=args.spill_points,
                           seed=args.seed)

    bounds = np.linspace(0, args.n_test, args.requests + 1).astype(int)
    spans = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    owned = [i for i in range(len(spans))
             if rendezvous_rank(("req", i), ctx.size, salt=args.seed) == ctx.rank]
    with router:
        router.warmup()
        t0 = time.time()
        futs = {i: router.submit(x_test[spans[i][0]:spans[i][1]], slo=args.slo)
                for i in owned}
        served = {i: f.result() for i, f in futs.items()}
        dt = time.time() - t0

    dtype = np.float32 if args.dtype == "f32" else np.float64
    kw = dict(bs_pred=args.bs_pred, m_pred=args.m_pred, seed=args.seed, n_sims=2,
              chunk_size=args.chunk, backend=args.backend, dtype=dtype,
              n_buckets=args.buckets, precision=args.precision, device=dev)
    t0 = time.time()
    mh = predict_sbv(params, x, y, x_test, multihost=ctx, **kw)
    t_mh = time.time() - t0
    serial = predict_sbv(params, x, y, x_test, **kw)
    mean_var = max(float(np.abs(mh.mean - serial.mean).max()),
                   float(np.abs(mh.var - serial.var).max()))
    sim = float(np.abs(mh.sim_mean - serial.sim_mean).max())
    # Scheduler-mode replicas pack with the base seed, so each served
    # request must reproduce its own lone predict_sbv call under any
    # routing; probe a bounded sample.
    served_err = 0.0
    for i in owned[:4]:
        a, b = spans[i]
        ref = predict_sbv(params, x, y, x_test[a:b], **kw)
        served_err = max(served_err,
                         float(np.abs(np.asarray(served[i].mean) - ref.mean).max()),
                         float(np.abs(np.asarray(served[i].var) - ref.var).max()))

    rs = router.stats.summary()
    out = {
        "rank": ctx.rank, "n_hosts": ctx.size,
        "n_requests": len(owned),
        "n_points": int(sum(spans[i][1] - spans[i][0] for i in owned)),
        "serve_s": dt, "multihost_predict_s": t_mh,
        "multihost_parity_max": max(mean_var, sim),
        "multihost_mean_var_max": mean_var,
        "multihost_sim_max": sim,
        "served_parity_max": served_err,
        "affinity_hit_rate": rs["affinity_hit_rate"],
        "replica_requests": rs["replica_requests"],
        "total_compiled_shapes": router.summary()["total_compiled_shapes"],
        "launches": ops.launch_counts(),
    }
    print(f"[serve-gp] rank {ctx.rank}/{ctx.size}: served {out['n_requests']}/{len(spans)} "
          f"requests ({out['n_points']} pts) in {dt:.2f}s over {len(servers)} replicas "
          f"({args.routing}); multihost predict {t_mh:.2f}s parity={max(mean_var, sim):.3g} "
          f"(mean/var {mean_var:.3g}) served parity={served_err:.3g}")
    if args.result_json:
        with open(f"{args.result_json}.rank{ctx.rank}", "w") as f:
            json.dump(out, f, indent=1)
    ctx.shutdown()
    return out


def serve_gp(argv=None):
    """The persistent micro-batching SBV prediction service.

    The test set is split into ``--requests`` asynchronous requests that
    are submitted concurrently; the server coalesces them into padded
    micro-batches and runs each through the double-buffered chunk pipeline;
    ``--compare`` races it against the serial chunk loop on the same
    workload. ``--replicas N`` serves
    through the shape-affinity ``ReplicaRouter``. Returns ``(mean, var)``
    of the served requests, concatenated."""
    from repro_torch.multihost import MultihostContext

    args = _gp_parser().parse_args(argv)
    dev = resolve_device(args.device)
    ctx = MultihostContext.from_env()
    if args.tuning_record:
        from repro_torch.tuning import apply_record

        args.buckets, args.stream_chunk, args.precision, args.backend = apply_record(
            args.tuning_record, n_buckets=args.buckets, stream_chunk=args.stream_chunk,
            precision=args.precision, backend=args.backend)
        print(f"[serve-gp] tuning record: buckets={args.buckets} "
              f"precision={args.precision} backend={args.backend} "
              f"stream-chunk={args.stream_chunk}")
    if args.backend is None:
        args.backend = "auto"
    if ctx is None and args.distributed_hosts and args.distributed_hosts > 1:
        return _spawn_serve_hosts(args, dev)
    if (args.replicas > 1 or ctx is not None) and args.scheduler != "continuous":
        print("[serve-gp] replica routing requires the continuous scheduler; enabling it")
        args.scheduler = "continuous"
    dtype = np.float32 if args.dtype == "f32" else np.float64

    from repro_torch.data.gp_sim import paper_synthetic
    from repro_torch.launch.fit_gp import load_dataset
    from repro_torch.serving import (BatchingPolicy, GPServer, GPServerConfig,
                                     PipelineConfig, ReplicaRouter, SchedulerPolicy,
                                     predict_pipelined, predict_synchronous)

    if args.outputs > 1 and (args.train_store or args.dataset == "synthetic"):
        raise SystemExit("--outputs > 1 requires --dataset metarvm "
                         "(in-core; the multi-output field variant)")
    if args.train_store:
        from repro_torch.data.store import ArrayStore

        if args.dataset != "synthetic":
            raise SystemExit("--train-store serves synthetic-generator params; fit other "
                             "datasets with fit_gp first")
        store = ArrayStore(args.train_store)
        # Kernel params of the same generator family (the store is taken to
        # hold a draw of it); the index is built out of core.
        _, _, params = paper_synthetic(args.seed, 128, d=store.d)
        x, y = store, None
    elif args.dataset == "synthetic":
        x, y, params = paper_synthetic(args.seed, args.n_train)
    else:
        x, y = load_dataset(args.dataset, args.n_train, args.seed, outputs=args.outputs)
        from repro_torch.core.fit import fit_sbv
        from repro_torch.core.pipeline import SBVConfig

        cfg = SBVConfig(n_blocks=max(1, args.n_train // 128), m=60, seed=args.seed)
        params = fit_sbv(x, y, cfg, inner_steps=30, outer_rounds=1, device=dev).params

    rng = np.random.default_rng(args.seed + 1)
    d = x.d if args.train_store else x.shape[1]
    x_test = rng.uniform(size=(args.n_test, d))

    mesh = None
    if args.workers > 1:
        from repro_torch.launch.mesh import make_worker_mesh

        mesh = make_worker_mesh(args.workers, devices=None if dev.type == "cuda" else dev)

    pipe_cfg = PipelineConfig(
        bs_pred=args.bs_pred, m_pred=args.m_pred, backend=args.backend, dtype=dtype,
        chunk_size=args.chunk, n_workers=args.workers, n_buckets=args.buckets,
        stream_chunk=args.stream_chunk, precision=args.precision,
    )
    sched_policy = None
    if args.scheduler == "continuous":
        sched_policy = SchedulerPolicy(queue_bound=args.queue_bound,
                                       spool_threshold=args.spool_threshold)
    cfg = GPServerConfig(
        pipeline=pipe_cfg,
        policy=BatchingPolicy(max_points=args.max_points or args.chunk,
                              max_wait_s=args.max_wait_ms / 1e3, adaptive=args.adaptive_wait),
        scheduler=sched_policy,
        pipelined=args.pipeline == "double",
        seed=args.seed,
    )
    if ctx is not None:
        return _serve_rank(ctx, args, params, x, y, x_test, cfg, dev)

    t0 = time.time()
    server = GPServer(params, x, y, cfg, mesh=mesh, device=dev)
    replicas = [server]
    replicas += [GPServer(params, x, y, cfg, mesh=mesh, index=server.index, device=dev)
                 for _ in range(args.replicas - 1)]
    n_train = x.n_rows if args.train_store else len(y)
    print(f"[serve-gp] train index over {n_train} pts (x{len(replicas)} replicas): "
          f"{time.time()-t0:.2f}s")
    front = server if args.replicas == 1 else ReplicaRouter(
        replicas, routing=args.routing, spill_points=args.spill_points, seed=args.seed)

    with front:
        t0 = time.time()
        front.warmup()
        print(f"[serve-gp] warmup: {time.time()-t0:.2f}s")

        # Concurrent request stream: near-equal splits of the test set.
        bounds = np.linspace(0, args.n_test, args.requests + 1).astype(int)
        t0 = time.time()
        futs = [front.submit(x_test[a:b], slo=args.slo)
                for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        results = [f.result() for f in futs]
        dt = time.time() - t0

        if server.n_outputs > 1:
            # The per-request output mask: a masked request's result
            # carries just the requested columns.
            fut = front.submit(x_test[:min(64, args.n_test)], slo=args.slo,
                               outputs=[server.n_outputs - 1])
            front.flush()
            masked = fut.result()
            assert masked.mean.shape[1] == 1, masked.mean.shape
            print(f"[serve-gp] {server.n_outputs}-output model; masked request returned "
                  f"{masked.mean.shape} (1 column)")

    def _arrays(res):
        return res.sink.materialize() if res.sink is not None else (res.mean, res.var)

    parts = [_arrays(r) for r in results]
    mean = np.concatenate([m for m, _ in parts])
    var = np.concatenate([v for _, v in parts])
    stats = server.stats.summary()
    print(f"[serve-gp] {args.n_test} predictions / {len(futs)} requests in {dt:.2f}s: "
          f"{args.n_test/dt:.0f} pts/s (backend={args.backend}, device={dev}, "
          f"workers={args.workers}, pipeline={args.pipeline}, scheduler={args.scheduler})")
    print(f"[serve-gp] batches={stats['n_batches']} "
          f"occupancy={stats['mean_batch_points']:.0f} pts/batch "
          f"latency p50={stats['latency_p50_s']*1e3:.1f}ms "
          f"p95={stats['latency_p95_s']*1e3:.1f}ms "
          f"compiled-shapes={stats['n_compiled_shapes']} "
          f"padding-occupancy={stats['padding_occupancy']:.3f}")
    if args.replicas > 1:
        rsum = front.summary()
        print(f"[serve-gp] router: replicas={args.replicas} routing={args.routing} "
              f"affinity-hit={rsum['affinity_hit_rate']:.2f} "
              f"spill-rate={rsum['spill_rate']:.2f} requests={rsum['replica_requests']} "
              f"shapes={[r['n_compiled_shapes'] for r in rsum['replicas']]} "
              f"(total {rsum['total_compiled_shapes']})")
    if args.scheduler == "continuous":
        per_cls = " ".join(
            f"{name}: n={c['n']} p50={c['latency_p50_s']*1e3:.1f}ms "
            f"p99={c['latency_p99_s']*1e3:.1f}ms"
            for name, c in stats["by_class"].items())
        print(f"[serve-gp] {per_cls} | queue-peak={stats['queue_depth_peak']} "
              f"preempted={stats['n_preempted']} rejected={stats['n_rejected']} "
              f"cancelled={stats['n_cancelled']}")
    assert np.all(np.isfinite(mean)) and np.all(var > 0)

    if args.result_json:
        from repro_torch.kernels import ops

        out = {"n_test": args.n_test, "n_requests": len(futs), "elapsed_s": dt,
               "points_per_s": args.n_test / dt,
               "server": {k: v for k, v in stats.items()
                          if isinstance(v, (int, float, str, bool))},
               "by_class": stats["by_class"], "launches": ops.launch_counts(),
               "precision": args.precision or "f64"}
        if args.replicas > 1:
            out["router"] = front.summary()
        with open(args.result_json, "w") as f:
            json.dump(out, f, indent=1)

    if args.compare:
        from repro_torch.core.predict import predict_sbv

        # Warm up on the exact chunk sequence first so the race measures
        # steady-state serving.
        predict_synchronous(params, server.index, x_test, pipe_cfg, seed=args.seed,
                            mesh=mesh, device=dev)
        for name, runner in (("sync", predict_synchronous), ("double", predict_pipelined)):
            t0 = time.time()
            m_r, v_r = runner(params, server.index, x_test, pipe_cfg, seed=args.seed,
                              mesh=mesh, device=dev)
            dt_r = time.time() - t0
            print(f"[serve-gp] compare {name:6s}: {dt_r:.2f}s ({args.n_test/dt_r:.0f} pts/s)")
            if name == "sync":
                m_sync, v_sync = m_r, v_r
        err = max(abs(m_r - m_sync).max(), abs(v_r - v_sync).max())
        print(f"[serve-gp] compare parity double vs sync: max|delta|={err:.2e}")
        assert err == 0.0, "pipelined chunk loop must be bitwise equal to sync"
        ref = predict_sbv(params, x, y, x_test, bs_pred=args.bs_pred, m_pred=args.m_pred,
                          seed=args.seed, n_sims=2, chunk_size=args.chunk,
                          n_workers=args.workers, backend="ref", dtype=dtype,
                          stream_chunk=args.stream_chunk, precision=args.precision,
                          device=dev)
        err = max(abs(m_r - ref.mean).max(), abs(v_r - ref.var).max())
        # Cross-backend parity at a narrow tier is bounded by the tier's
        # assembly rounding, not by the f64 chunk protocol's tolerance.
        tol = {"bf16": 0.5, "f32": 1e-3}.get(
            args.precision, 1e-5 if dtype == np.float64 else 1e-3)
        print(f"[serve-gp] compare parity vs predict_sbv: max|delta|={err:.2e}")
        assert err <= tol, err

    # Serving returns the analytic conditionals only; conditional
    # simulation is the library path: predict_sbv(..., n_sims=...).
    return mean, var


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "gp":
        return serve_gp(argv[1:])

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import mesh_line, meta_cache
    from repro_torch.models.model import init_params, prefill_step, serve_step
    from repro_torch.sharding.rules import tp_size

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--sharded", action="store_true",
                    help="split the weights and the cache over the mesh's rank processes")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="--sharded: seconds for the rendezvous and the ranks' run")
    args = ap.parse_args(argv)
    try:
        mesh = make_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    tp = tp_size(mesh)
    comm = None
    if args.sharded:
        from repro_torch.launch.train import launch_ranks
        from repro_torch.sharding.collectives import MeshComm

        comm = MeshComm.from_env(mesh)
        if comm is None:
            launch_ranks("repro_torch.launch.serve", argv, mesh, args.timeout)
            return None

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cache_len = args.prompt_len + args.max_new

    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device, tp=tp)
    if comm is None:
        print(mesh_line(cfg, mesh, model, meta_cache(cfg, args.batch, cache_len, tp, model.dtype)))

    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)), dtype=torch.int32
    ).to(device)
    if comm is not None:
        from repro_torch.sharding.placement import shard_batch, shard_model

        model = shard_model(model, mesh, comm.rank, comm)
        prompt = shard_batch(prompt, mesh, comm.rank)

    with torch.inference_mode():
        _sync(device)
        t0 = time.time()
        logits, cache = prefill_step(model, prompt, cache_len, tp=tp)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        _sync(device)
        print(f"[serve] prefill {args.batch}x{args.prompt_len}: {time.time()-t0:.2f}s")
        if comm is not None:
            from repro_torch.configs import ShapeSpec
            from repro_torch.launch.train import sharded_mesh_line

            nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
            measured = {"params": nbytes(model.parameters()),
                        "cache": nbytes(v for v in cache.values() if torch.is_tensor(v))}
            print(sharded_mesh_line(cfg, mesh, comm.rank, measured,
                                    ShapeSpec("cli", cache_len, args.batch, "decode")))

        out = [tok]
        t0 = time.time()
        for _ in range(args.max_new - 1):
            logits, cache = serve_step(model, tok, cache, tp=tp)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(tok)
        toks = torch.cat(out, dim=1)
        _sync(device)
        dt = time.time() - t0
    rate = args.batch * (args.max_new - 1) / dt
    print(f"[serve] decoded {args.max_new-1} steps x {args.batch} seqs: "
          f"{dt:.2f}s ({rate:.1f} tok/s)")
    print("[serve] sample tokens:", toks[0, :16].cpu().numpy())
    if comm is not None:
        print(f"[serve] rank {comm.rank} collectives: {comm.summary()}")
        comm.shutdown()
    return toks


if __name__ == "__main__":
    main()
