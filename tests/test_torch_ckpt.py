"""Port vs reference: checkpoints (tests/test_ckpt.py's cases, on the port).

The on-disk format is shared (``step_<n>/manifest.json`` + ``shard_<host>.npz``,
dotted leaf names, bf16 as its uint16 bit pattern beside a ``__bf16__``
marker), so each package loads the other's checkpoints. Every leaf is held
bitwise (bf16 through its int16 view), and so are the manifests' names.
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as ref_ckpt  # noqa: E402
from repro.optim import adam_init as ref_adam_init  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, load_checkpoint,  # noqa: E402
                              load_tuning_record, restore_train_state, save_checkpoint)
from repro_torch.ckpt.checkpoint import _flatten, latest_checkpoint  # noqa: E402
from repro_torch.optim.adam import AdamState  # noqa: E402


def make_state(seed=0):
    """The reference test's state, as torch leaves (the same dotted names:
    ``opt.mu.a``, ``params.nested.w``, ``step``, ...)."""
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(4, 8, generator=g, dtype=torch.float32),
              "nested": {"w": torch.randn(3, 3, generator=g).to(torch.bfloat16)}}
    f32 = lambda t: {k: (f32(v) if isinstance(v, dict) else v.to(torch.float32))
                     for k, v in t.items()}
    return {"params": params,
            "opt": AdamState(step=torch.zeros((), dtype=torch.int32), mu=f32(params),
                             nu=f32(params)),
            "step": torch.tensor(7, dtype=torch.int32)}


def ref_state(seed=0):
    k = jax.random.key(seed)
    params = {"a": jax.random.normal(k, (4, 8), jnp.float32),
              "nested": {"w": jax.random.normal(k, (3, 3), jnp.bfloat16)}}
    return {"params": params, "opt": ref_adam_init(params), "step": jnp.int32(7)}


def _bits(a):
    """A leaf's raw bits as numpy: bf16 (torch or ml_dtypes) as int16."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_flat_bitwise(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for name in a:
        x, y = _bits(a[name]), _bits(b[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_roundtrip(tmp_path):
    state = make_state()
    path = save_checkpoint(str(tmp_path), 7, state, extras={"stream": {"i": 3}})
    restored, manifest = restore_train_state(path, state, device="cpu")
    assert manifest["step"] == 7
    assert manifest["extras"]["stream"]["i"] == 3
    assert_flat_bitwise(_flatten(state), _flatten(restored))
    assert isinstance(restored["opt"], AdamState)
    assert restored["params"]["nested"]["w"].dtype == torch.bfloat16


def test_bf16_preserved(tmp_path):
    state = make_state()
    path = save_checkpoint(str(tmp_path), 1, state)
    flat, _ = load_checkpoint(path)
    assert flat["params.nested.w"].dtype == torch.bfloat16


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = make_state()
    for step in (1, 2, 3, 4):
        mgr.save(step, state, block=True)
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["step_00000003", "step_00000004"], kept
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000004")


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = make_state()
    mgr.save(10, state)            # async
    mgr.save(11, state)            # waits for 10, then async 11
    mgr.close()
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000010", "step_00000011"], names


def test_restore_onto_other_dtypes_and_device(tmp_path):
    """The reference re-shards onto a new mesh; the port's counterpart is a
    restore onto another template: leaves land on ``device`` at the
    template's dtypes."""
    state = make_state()
    path = save_checkpoint(str(tmp_path), 3, state)
    template = dict(state, params={"a": state["params"]["a"].double(),
                                   "nested": state["params"]["nested"]})
    restored, _ = restore_train_state(path, template, device="cpu")
    assert restored["params"]["a"].dtype == torch.float64
    np.testing.assert_array_equal(restored["params"]["a"].numpy(),
                                  state["params"]["a"].double().numpy())
    assert all(t.device.type == "cpu" for t in _flatten(restored).values())


def test_restore_without_cuda_or_device_raises(tmp_path, monkeypatch):
    state = make_state()
    path = save_checkpoint(str(tmp_path), 3, state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_train_state(path, state)


def test_crash_mid_save_leaves_no_partial(tmp_path):
    """A .tmp directory must never be visible as a valid checkpoint."""
    state = make_state()
    save_checkpoint(str(tmp_path), 1, state)
    os.makedirs(tmp_path / "step_00000002.tmp0/")  # simulated dead save
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000001")


def test_sigterm_saves_the_provided_state(tmp_path):
    """The SIGTERM handler drains, saves the provider's state and exits 143."""
    mgr = CheckpointManager(str(tmp_path), keep=3, install_sigterm=True)
    try:
        state = make_state()
        mgr.register_state_provider(lambda: (5, state, {"why": "preempted"}))
        with pytest.raises(SystemExit) as exc:
            mgr._on_sigterm(signal.SIGTERM, None)
        assert exc.value.code == 143
        flat, manifest = load_checkpoint(latest_checkpoint(str(tmp_path)))
        assert manifest["step"] == 5 and manifest["extras"] == {"why": "preempted"}
        assert_flat_bitwise(flat, _flatten(state))
    finally:
        signal.signal(signal.SIGTERM, mgr._prev_handler)


# -- cross-loads ---------------------------------------------------------------


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    """A reference checkpoint (bf16 leaf included) loads bitwise in the port,
    and restores onto a port template of the same names."""
    rstate = ref_state()
    path = ref_ckpt.save_checkpoint(str(tmp_path), 4, rstate, extras={"k": 1})
    flat, manifest = load_checkpoint(path)
    want, want_manifest = ref_ckpt.load_checkpoint(path)
    assert manifest["names"] == want_manifest["names"] and manifest["extras"] == {"k": 1}
    assert flat["params.nested.w"].dtype == torch.bfloat16
    assert_flat_bitwise(flat, want)
    restored, _ = restore_train_state(path, make_state(), device="cpu")
    assert_flat_bitwise(_flatten(restored), want)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """A port checkpoint (bf16 leaf included) loads bitwise in the reference
    (``load_checkpoint`` and ``restore_train_state`` onto its template)."""
    state = make_state()
    path = save_checkpoint(str(tmp_path), 4, state, extras={"k": 2})
    flat, manifest = ref_ckpt.load_checkpoint(path)
    assert manifest["extras"] == {"k": 2}
    assert flat["params.nested.w"].dtype == jnp.bfloat16
    assert_flat_bitwise(flat, _flatten(state))
    restored, _ = ref_ckpt.restore_train_state(path, ref_state())
    assert_flat_bitwise(ref_ckpt.checkpoint._flatten(restored), _flatten(state))


def test_tuning_record_roundtrip(tmp_path):
    """The reference test's record: persists next to the checkpoints and
    reloads to the same dict from the directory or the json path; an
    absent record reads as None, a newer version refuses to load."""
    from repro_torch.tuning import TuningRecord, as_record

    assert load_tuning_record(str(tmp_path)) is None
    assert TuningRecord.load(str(tmp_path)) is None
    rec = TuningRecord(
        n_buckets=4, bs_ceilings=[16, 32], m_ceilings=[30, 30],
        bs_mult=16, m_mult=128, backend="auto", precision="bf16",
        bucket_tiers=["bf16", "f64"], error_budget=None, stream_chunk=65536,
        device_cache_budget=1 << 30, occupancy=0.71,
        histogram={"bs": {"min": 3, "p50": 12, "max": 31, "mean": 13.0}},
        candidates=[{"n_buckets": 4, "precision": "bf16", "time_s": 0.01}],
        meta={"device": "cpu", "n_rows": 100000},
    )
    path = rec.save(str(tmp_path))
    assert os.path.basename(path) == "tuning_record.json"
    for src in (str(tmp_path), path):
        back = TuningRecord.load(src)
        assert back is not None and back.to_dict() == rec.to_dict()
        assert as_record(src).to_dict() == rec.to_dict()
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    with pytest.raises(ValueError):
        TuningRecord.from_dict(dict(rec.to_dict(), version=rec.version + 1))
    with pytest.raises(FileNotFoundError):
        as_record(str(tmp_path / "nope"))
    # The file is byte-identical to the reference's save of the same dict.
    ref_dir = tmp_path / "ref"
    ref_ckpt.save_tuning_record(str(ref_dir), rec.to_dict())
    assert (ref_dir / "tuning_record.json").read_bytes() == open(path, "rb").read()
