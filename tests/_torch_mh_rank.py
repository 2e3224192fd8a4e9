"""One rank of the port's multi-host tests (tests/test_torch_multihost.py).

Started by ``repro_torch.multihost.spawn_ranks`` with the
``REPRO_TORCH_DIST_*`` environment, it joins the gloo process group and
writes what the test compares to ``<out>.rank<r>.npz``:

    python tests/_torch_mh_rank.py structure STORE OUT BLOCKS M CHUNK BATCH
    python tests/_torch_mh_rank.py predict STORE XTEST OUT
    python tests/_torch_mh_rank.py comm OUT
    python tests/_torch_mh_rank.py fail OUT

``fail``: rank 1 exits at once with code 3 while rank 0 waits in an
all-reduce, which only the launcher can end.
"""
import sys

import numpy as np
import torch

from repro_torch.core import SBVConfig
from repro_torch.core.kernels_math import KernelParams
from repro_torch.core.predict import predict_sbv
from repro_torch.data.store import ArrayStore, PartitionedStore
from repro_torch.data.streaming import multihost_preprocess, pack_block_chunk
from repro_torch.multihost import MultihostContext

PREDICT_KW = dict(bs_pred=8, m_pred=24, seed=3, n_sims=5, chunk_size=64, device="cpu")


def _ragged(lists):
    """A list of int arrays as (concatenation, lengths)."""
    lens = np.asarray([len(a) for a in lists], dtype=np.int64)
    cat = np.concatenate(lists).astype(np.int64) if lists else np.empty(0, np.int64)
    return cat, lens


def structure(ctx, store_dir, blocks, m, chunk, batch):
    store = ArrayStore(store_dir)
    cfg = SBVConfig(n_blocks=int(blocks), m=int(m), seed=0)
    pstore = PartitionedStore(store, ctx.size, ctx.rank)
    beta = np.full(store.d, 0.4)
    s = multihost_preprocess(pstore, beta, cfg, int(chunk), ctx, struct_batch=int(batch))
    owned = np.nonzero(s.host_of_block == ctx.rank)[0]
    out = dict(order=s.blocks.order, rank_of_block=s.blocks.rank_of_block,
               centers=s.blocks.centers, host_of_block=s.host_of_block, sizes=s.sizes,
               domain_volume=s.domain_volume, bs_max=s.bs_max, owned=owned,
               owned_rows=s.stats["owned_rows"], halo_rows=s.stats["halo_rows"])
    out["members"], out["members_len"] = _ragged([s.blocks.members[b] for b in owned])
    out["neigh"], out["neigh_len"] = _ragged([s.neigh[b] for b in owned])
    out["plan"], out["plan_len"] = _ragged(s.plan)
    pieces = [pack_block_chunk(s.table, s.blocks, s.neigh, r, m=cfg.m, bs_max=s.bs_max)
              for r in s.plan]
    for k in ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask"):
        out[k] = np.concatenate([getattr(p, k) for p in pieces]) if pieces else np.empty(0)
    return out


def predict(ctx, store_dir, xtest):
    x, y = ArrayStore(store_dir).read_slice(0, ArrayStore(store_dir).n_rows)
    xq = np.load(xtest)
    params = KernelParams.create(sigma2=1.0, beta=0.3, nugget=1e-3, d=x.shape[1])
    out = {}
    for tag, nb in (("uniform", None), ("bucketed", 2)):
        pred = predict_sbv(params, x, y, xq, n_buckets=nb, multihost=ctx, **PREDICT_KW)
        for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
            out[f"{tag}_{f}"] = getattr(pred, f)
    return out


def comm(ctx):
    r = ctx.rank
    vec = np.asarray([r + 0.1, -r * 1e-300, 1.0 / (r + 3)])
    got = ctx.exchange({dst: {"src": np.asarray([r]), "rows": np.arange(dst + 1.0)}
                        for dst in range(ctx.size) if dst != (r + 1) % ctx.size})
    srcs = np.asarray(sorted(got), dtype=np.int64)
    return dict(sum=ctx.allreduce(vec), max=ctx.allreduce(vec, "max"),
                min=ctx.allreduce(vec, "min"), scalar=ctx.allreduce_scalar(float(r), "max"),
                srcs=srcs, echo=np.asarray([int(got[s]["src"][0]) for s in srcs]),
                rows=np.asarray([got[s]["rows"].size for s in srcs]),
                bytes_sent=ctx.bytes_sent, bytes_recv=ctx.bytes_recv)


def main():
    torch.set_num_threads(1)
    mode, *args = sys.argv[1:]
    ctx = MultihostContext.from_env()
    if mode == "fail":
        if ctx.rank == 1:
            sys.exit(3)
        ctx.allreduce(np.ones(1))
        return
    out_path = args[-1] if mode != "structure" else args[1]
    if mode == "structure":
        out = structure(ctx, args[0], *args[2:])
    elif mode == "predict":
        out = predict(ctx, args[0], args[1])
    else:
        out = comm(ctx)
    np.savez(f"{out_path}.rank{ctx.rank}.npz", **out)
    ctx.shutdown()


if __name__ == "__main__":
    main()
