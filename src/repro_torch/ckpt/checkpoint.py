"""Checkpoint / restart: atomic name-keyed saves, async writes, keep-last-k.

Counterpart of ``repro.ckpt.checkpoint``, with the same on-disk format, so
each package reads the other's checkpoints:

* a checkpoint is a directory ``step_<n>/`` holding one ``manifest.json``
  and one ``shard_<host>.npz`` per host. Leaves are stored under their
  dotted names (``_flatten``) in canonical, unsharded layout, so a restore
  does not depend on how the saving run placed them;
* writes are atomic: the shard and the fsync'd manifest land in
  ``step_<n>.tmp<host>/``, which is renamed only when complete, so a crash
  mid-save never corrupts the latest complete checkpoint;
* numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bit
  pattern beside a ``__bf16__<name>`` marker, and read back as a
  ``torch.bfloat16`` tensor through an integer view (no ``ml_dtypes``);
* ``CheckpointManager`` adds background-thread saves (the caller hands off
  host copies and keeps going; at most one write in flight), keep-last-k
  cleanup and a SIGTERM handler for a final save on preemption;
* JSON-serialisable extras (a data iterator's position, say) ride in the
  manifest;
* a sharded training run (``launch.train --sharded``) gathers its state
  and rank 0 writes it here whole, so its checkpoints are these.

Leaves may be ``torch.Tensor`` (any device), numpy arrays or Python
scalars. ``restore_train_state(path, template, device=)`` rebuilds the
template's structure with every leaf a tensor on ``device``; the
reference's ``shardings`` (a JAX mesh placement) has no single-process
counterpart here.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time

import numpy as np
import torch

_MANIFEST = "manifest.json"
_BF16 = "__bf16__"


def _flatten(tree, prefix=""):
    """Flatten a tree of dicts / NamedTuples / lists into {dotted-name: leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}."))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to every leaf (the structure ``_flatten`` walks)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_map_leaves(fn, getattr(tree, k)) for k in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _host_leaf(leaf):
    """A host copy of one leaf: numpy, except bf16, which stays a CPU
    ``torch.bfloat16`` tensor (numpy has no such dtype)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.array(leaf)


def _stored(leaf) -> tuple[np.ndarray, bool]:
    """``(array, is_bf16)``: the numpy array written for one leaf, bf16 as
    its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), True
        return leaf.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array handed in by a caller
        return arr.view(np.uint16), True
    return arr, False


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """A uint16 bit pattern as a ``torch.bfloat16`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _unflatten_into(template, flat, prefix=""):
    """Rebuild ``template``'s structure with leaves taken from ``flat``, each
    cast to its template leaf's dtype where the template has one."""
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}{k}.") for k in template}
    if hasattr(template, "_fields"):
        return type(template)(
            *[_unflatten_into(getattr(template, k), flat, f"{prefix}{k}.")
              for k in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}{i}.") for i, v in enumerate(template))
    leaf = flat[prefix[:-1]]
    if isinstance(template, torch.Tensor):
        leaf = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        return leaf.to(template.dtype)
    if isinstance(template, np.ndarray) and not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf).astype(template.dtype, copy=False)
    return leaf


def save_checkpoint(directory: str, step: int, state, extras: dict | None = None,
                    host_id: int = 0, n_hosts: int = 1) -> str:
    """Atomic synchronous save. Returns the final checkpoint path."""
    flat = _flatten(state)
    names = sorted(flat)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)

    # Each host owns every n_hosts-th name (canonical layout).
    shard = {}
    for name in names[host_id::n_hosts]:
        arr, bf16 = _stored(flat[name])
        shard[name] = arr
        if bf16:
            shard[_BF16 + name] = np.array(1)
    np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **shard)

    if host_id == 0:
        manifest = {"step": step, "names": names, "n_hosts": n_hosts,
                    "extras": extras or {}, "time": time.time()}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
    # Single-host rename; on a fleet host 0 renames after a barrier.
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """``(flat, manifest)``: ``flat`` maps each dotted name to a numpy array,
    or to a CPU ``torch.bfloat16`` tensor for a bf16 leaf."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = {}
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(path, fn)) as z:
            for name in z.files:
                if name.startswith(_BF16):
                    continue
                arr = z[name]
                flat[name] = _bf16_tensor(arr) if _BF16 + name in z.files else arr
    missing = set(manifest["names"]) - set(flat)
    if missing:
        raise IOError(f"checkpoint {path} missing leaves: {sorted(missing)[:5]}...")
    return flat, manifest


def restore_train_state(path: str, template, device=None):
    """Rebuild ``template``-structured state from ``path``: ``(state,
    manifest)`` with every leaf a tensor on ``device`` (default: the
    current CUDA device; pass ``device='cpu'`` without a GPU), at its
    template leaf's dtype."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    flat, manifest = load_checkpoint(path)
    state = _unflatten_into(template, flat)
    state = _map_leaves(lambda leaf: torch.as_tensor(leaf).to(dev), state)
    return state, manifest


_TUNING_RECORD = "tuning_record.json"


def save_tuning_record(directory: str, record: dict) -> str:
    """Atomically persist an autotuner record (a JSON-plain dict,
    ``repro_torch.tuning.TuningRecord.to_dict()``) next to the checkpoints,
    so a later ``fit_sbv`` / ``predict_sbv`` / ``GPServer`` starts pre-tuned.
    Same tmp-and-rename discipline as ``save_checkpoint``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, _TUNING_RECORD)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return final


def load_tuning_record(directory: str) -> dict | None:
    """Record dict from a checkpoint directory (or a direct path to the
    json file); ``None`` when absent."""
    path = directory
    if os.path.isdir(path):
        path = os.path.join(path, _TUNING_RECORD)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    steps = [d for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp0")
             and os.path.exists(os.path.join(directory, d, _MANIFEST))]
    if not steps:
        return None
    return os.path.join(directory, max(steps))


class CheckpointManager:
    """Async double-buffered saves + keep-last-k cleanup + SIGTERM drain.

    ``save()`` copies the state to the host (blocking only for the copy),
    then writes on a background thread; at most one write is in flight, a
    second save waits for it. ``close()`` drains."""

    def __init__(self, directory: str, keep: int = 3, install_sigterm: bool = False):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        if install_sigterm:
            self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        self._last_state_fn = None

    # -- preemption ---------------------------------------------------
    def _on_sigterm(self, signum, frame):
        self.close()
        if self._last_state_fn is not None:
            step, state, extras = self._last_state_fn()
            save_checkpoint(self.directory, step, state, extras)
        raise SystemExit(143)

    def register_state_provider(self, fn):
        """fn() -> (step, state, extras); called on SIGTERM for a final save."""
        self._last_state_fn = fn

    # -- async save ---------------------------------------------------
    def save(self, step: int, state, extras: dict | None = None, block: bool = False):
        host_state = _map_leaves(_host_leaf, state)
        self.wait()  # double buffer: at most one outstanding write

        def write():
            save_checkpoint(self.directory, step, host_state, extras)
            self._gc()

        if block:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()

    def close(self):
        self.wait()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and ".tmp" not in d)
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def latest(self) -> str | None:
        return latest_checkpoint(self.directory)
