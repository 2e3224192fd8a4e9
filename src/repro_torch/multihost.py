"""Multi-process host communication for the distributed streaming build.

Counterpart of ``repro.multihost``. The paper's Alg. 2 runs construction per
MPI rank with two communication primitives: an all-reduce over small dense
summaries (k-means centers and counts, radii, loss/grad scalars) and a
point-to-point candidate/member exchange. ``MultihostContext`` provides both
on ``torch.distributed`` with the gloo backend, over host float64 data:

* **collectives**: ``allreduce`` is an ``all_gather`` followed by a sum (or
  max, min) in rank order, so every rank gets the identical reduced bytes,
  whatever algorithm gloo picks. That keeps optimizer states replicated
  without a broadcast. The vectors are small (1 + n_param scalars per chunk
  per step in the fit, O(bc) summaries in the construction);
* **point-to-point**: ``exchange`` moves ``npz``-serialized array payloads
  between rank pairs as gloo ``isend`` / ``irecv`` of uint8 tensors, tagged
  with a sequence number, after one ``all_gather`` of the payload sizes.
  The steady-state inner loop communicates ONLY through ``allreduce``.

NCCL is not used: two ranks may share one card, which NCCL refuses, and the
reduced data live on the host anyway. A failed rendezvous raises; nothing
falls back to ``LoopbackComm``.

``LoopbackComm`` implements the same interface for one process; every
``comm=``-aware code path can therefore be exercised (and is held bitwise
against the single-process path) without spawning processes.

Ranks find each other through a ``TCPStore``. ``spawn_ranks`` starts K
fresh interpreters on this host with the ``REPRO_TORCH_DIST_*`` environment
and hosts the store itself on a port the OS picks; on a cluster, export the
variables on every host and rank 0 hosts the store at
``REPRO_TORCH_DIST_COORD``.
"""
from __future__ import annotations

import io
import os
import subprocess
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

# Environment contract for launched rank processes (repro_torch.launch.fit_gp
# spawns local ranks with these; a real cluster can export them instead).
ENV_RANK = "REPRO_TORCH_DIST_RANK"
ENV_NPROCS = "REPRO_TORCH_DIST_NPROCS"
ENV_COORD = "REPRO_TORCH_DIST_COORD"          # host:port of the TCPStore
ENV_TIMEOUT = "REPRO_TORCH_DIST_TIMEOUT"      # seconds for the rendezvous and each collective
ENV_STORE_HOSTED = "REPRO_TORCH_DIST_STORE_HOSTED"  # "1": the launcher hosts the store
DEFAULT_TIMEOUT_S = 600.0


def partition_blocks(n_blocks: int, size: int) -> list:
    """Contiguous ``[lo, hi)`` block spans per rank (``np.array_split``
    semantics: the first ``n_blocks % size`` ranks carry one extra).
    Every rank computes the identical table from the identical packed
    chunk, so block ownership in the multi-host predict path
    (``predict_sbv(multihost=)``) needs zero coordination."""
    base, extra = divmod(int(n_blocks), int(size))
    spans, lo = [], 0
    for r in range(int(size)):
        hi = lo + base + (1 if r < extra else 0)
        spans.append((lo, hi))
        lo = hi
    return spans


class LoopbackComm:
    """Single-process implementation of the host-comm interface.

    ``allreduce`` is the identity (so it perturbs no floats: the
    ``multihost=`` fit path with a LoopbackComm is bitwise the plain
    streaming fit) and ``exchange`` hands each payload straight back.
    """

    rank = 0
    size = 1

    def allreduce(self, vec, op: str = "sum") -> np.ndarray:
        return np.asarray(vec, dtype=np.float64).copy()

    def allreduce_scalar(self, v: float, op: str = "sum") -> float:
        return float(v)

    def exchange(self, payloads: dict) -> dict:
        out = {}
        if 0 in payloads:
            out[0] = {k: np.asarray(v) for k, v in payloads[0].items()}
        return out

    def barrier(self, tag: str = "") -> None:
        pass

    def shutdown(self) -> None:
        pass


class MultihostContext:
    """Host comm over an initialized gloo process group."""

    def __init__(self, rank: int, size: int, store, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.rank = int(rank)
        self.size = int(size)
        self._store = store  # keeps the TCPStore (and its server on rank 0) alive
        self._seq = 0
        self.timeout_s = float(timeout_s)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.exchange_s = 0.0
        self.allreduce_s = 0.0

    # -- construction --------------------------------------------------

    @classmethod
    def connect(cls, coordinator: str, num_processes: int, process_id: int,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                host_store: bool | None = None) -> "MultihostContext":
        """Join the gloo process group whose ``TCPStore`` is at
        ``coordinator`` (``host:port``). Rank 0 hosts the store unless
        ``host_store`` is False (a launcher hosts it). Raises when the
        rendezvous does not complete within ``timeout_s``."""
        import torch.distributed as dist

        host, port = coordinator.rsplit(":", 1)
        rank, size = int(process_id), int(num_processes)
        if host_store is None:
            host_store = rank == 0
        timeout = timedelta(seconds=float(timeout_s))
        store = dist.TCPStore(host, int(port), None, bool(host_store), timeout=timeout,
                              wait_for_workers=False)
        dist.init_process_group("gloo", store=dist.PrefixStore("repro_torch", store),
                                rank=rank, world_size=size, timeout=timeout)
        return cls(rank, size, store, timeout_s)

    @classmethod
    def from_env(cls) -> "MultihostContext | None":
        """Connect from the ``REPRO_TORCH_DIST_*`` environment, or None."""
        if ENV_RANK not in os.environ:
            return None
        rank = int(os.environ[ENV_RANK])
        return cls.connect(os.environ[ENV_COORD], int(os.environ[ENV_NPROCS]), rank,
                           timeout_s=float(os.environ.get(ENV_TIMEOUT, DEFAULT_TIMEOUT_S)),
                           host_store=rank == 0 and os.environ.get(ENV_STORE_HOSTED) != "1")

    # -- collectives ----------------------------------------------------

    def _gather(self, t):
        import torch
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return parts

    def allreduce(self, vec, op: str = "sum") -> np.ndarray:
        """Element-wise sum/max/min across ranks of a float64 vector.

        Every rank gathers all ranks' vectors and reduces them in rank
        order, so the result is identical bytes on every rank: replicated
        state (centers, optimizer moments, parameters) stays in lockstep
        without a broadcast."""
        import torch

        if op not in ("sum", "max", "min"):
            raise ValueError(f"unknown reduction {op!r}")
        arr = np.asarray(vec, dtype=np.float64)
        if arr.size == 0:
            return arr.copy()
        t0 = time.perf_counter()
        local = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).copy())
        parts = [p.numpy() for p in self._gather(local)]
        if op == "sum":
            out = parts[0].copy()
            for p in parts[1:]:
                out += p
        else:
            out = (np.max if op == "max" else np.min)(np.stack(parts), axis=0)
        self.allreduce_s += time.perf_counter() - t0
        return out.reshape(arr.shape)

    def allreduce_scalar(self, v: float, op: str = "sum") -> float:
        return float(self.allreduce(np.asarray([v], dtype=np.float64), op)[0])

    # -- point-to-point -------------------------------------------------

    @staticmethod
    def _pack(payload: dict) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.ascontiguousarray(v) for k, v in payload.items()})
        return buf.getvalue()

    @staticmethod
    def _unpack(blob: bytes) -> dict:
        with np.load(io.BytesIO(blob)) as z:
            return {k: z[k] for k in z.files}

    def exchange(self, payloads: dict) -> dict:
        """All-to-all of ``{dest_rank: {name: array}}`` payload dicts.

        COLLECTIVE: every rank must call it the same number of times
        (missing destinations send implicit empty payloads). Returns
        ``{src_rank: {name: array}}`` with an entry for every peer that
        sent a non-empty payload (plus self, if addressed). One
        ``all_gather`` of the payload sizes, then gloo ``isend``/``irecv``
        of the non-empty ones, tagged with this call's sequence number."""
        import torch
        import torch.distributed as dist

        seq = self._seq
        self._seq += 1
        t0 = time.perf_counter()
        out = {}
        mine = payloads.get(self.rank)
        if mine is not None:
            out[self.rank] = {k: np.asarray(v) for k, v in mine.items()}
        sizes = torch.zeros(self.size, dtype=torch.int64)
        blobs = {}
        for dst in range(self.size):
            if dst != self.rank and payloads.get(dst):
                blobs[dst] = torch.frombuffer(bytearray(self._pack(payloads[dst])),
                                              dtype=torch.uint8)
                sizes[dst] = blobs[dst].numel()
        table = self._gather(sizes)
        works, recv = [], {}
        for dst, blob in blobs.items():
            works.append(dist.isend(blob, dst, tag=seq))
            self.bytes_sent += blob.numel()
        for src in range(self.size):
            nb = int(table[src][self.rank])
            if src != self.rank and nb:
                recv[src] = torch.empty(nb, dtype=torch.uint8)
                works.append(dist.irecv(recv[src], src, tag=seq))
                self.bytes_recv += nb
        for w in works:
            w.wait()
        for src, buf in recv.items():
            out[src] = self._unpack(buf.numpy().tobytes())
        self.exchange_s += time.perf_counter() - t0
        return out

    def barrier(self, tag: str = "") -> None:
        import torch.distributed as dist

        dist.barrier()

    def shutdown(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        self._store = None


def spawn_ranks(argv: list, n_ranks: int, timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``argv`` as ``n_ranks`` fresh rank processes on this host and
    wait for them: ``[(returncode, output), ...]`` in rank order.

    This process hosts the ranks' ``TCPStore`` on a port the OS picks (no
    race for a free port) and hands it over in ``REPRO_TORCH_DIST_COORD``,
    with the rank, the rank count and ``timeout_s`` (the rendezvous and
    collective timeout). Ranks are new interpreters (never a fork of a
    process that may hold a CUDA context), with this package on their
    ``PYTHONPATH``. When a rank fails, or ``timeout_s`` passes before all
    have exited, the others are killed: a rank waiting in a collective on
    a dead peer does not hang the caller."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, None, True, timeout=timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    base = dict(os.environ)
    src = str(Path(__file__).resolve().parent.parent)
    base["PYTHONPATH"] = os.pathsep.join(p for p in (src, base.get("PYTHONPATH")) if p)
    base.update({ENV_NPROCS: str(n_ranks), ENV_COORD: f"127.0.0.1:{store.port}",
                 ENV_TIMEOUT: str(timeout_s), ENV_STORE_HOSTED: "1"})
    with tempfile.TemporaryDirectory(prefix="repro-torch-ranks-") as logs:
        procs, files = [], []
        try:
            for r in range(n_ranks):
                files.append(open(os.path.join(logs, f"rank{r}.log"), "w+"))
                procs.append(subprocess.Popen([str(a) for a in argv],
                                              env={**base, ENV_RANK: str(r)},
                                              stdout=files[-1], stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.returncode for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for p, f in zip(procs, files):
            f.seek(0)
            results.append((p.returncode, f.read()))
            f.close()
    del store
    return results

