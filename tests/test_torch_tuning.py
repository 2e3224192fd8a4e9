"""Port vs reference: the autotuner and its records (tests/test_buckets.py's
``test_autotune_record_reproduces_choices``, tests/test_ckpt.py's record).

- ``recommend_stream_chunk``: equal to the reference's over a grid of
  inputs (exact integers, or both None).
- Records: a record written by either package loads in the other to the
  same dict; a reference record naming its TPU backend (``'pallas'``)
  drives the port as ``'auto'`` and is saved again unchanged.
- ``autotune_loglik`` on the CPU at the reference test's size (the skewed
  5-cluster data, 10 blocks, m = 12, K in (0, 2), tiers bf16 and f64): the
  histogram, and each candidate's assigned tiers and occupancy at the same
  (K, tier), equal the reference's exactly. Which candidate wins depends on
  timing, so the winner is not compared.
- ``fit_sbv(tuning=)`` / ``predict_sbv(tuning=)`` / ``tuned_config``: equal
  (bitwise) to the calls with the record's knobs passed explicitly, and
  explicit arguments win over the record. A fit probes the record's
  requested tier; prediction and serving take the widest tier the record's
  buckets settled at (``bucket_tiers``), so a "bf16" record whose buckets
  all ran f64 predicts in f64.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_buckets import PAR, skewed_data  # noqa: E402

from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.tuning import TuningRecord as RefRecord  # noqa: E402
from repro.tuning import autotune_loglik as ref_autotune  # noqa: E402
from repro.tuning import recommend_stream_chunk as ref_recommend  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import SBVConfig  # noqa: E402
from repro_torch.core.fit import fit_sbv  # noqa: E402
from repro_torch.core.predict import predict_sbv  # noqa: E402
from repro_torch.serving import PipelineConfig, tuned_config  # noqa: E402
from repro_torch.tuning import (TuningRecord, as_record, autotune_loglik,  # noqa: E402
                                port_backend, recommend_stream_chunk)

P = params_from_reference(*(np.asarray(a) for a in PAR))


@pytest.mark.parametrize("tier", ["bf16", "f32", "f64"])
@pytest.mark.parametrize("n_rows, d, m, bs_avg, budget", [
    (10**6, 10, 200, 100.0, 1 << 30), (5000, 3, 12, 7.5, 1 << 28),
    (10**7, 10, 60, 50.0, 8 << 30), (2 * 10**8, 10, 200, 0.5, 80 << 30),
    (50_000, 1, 1, 1.0, 0), (3 * 10**9, 100, 400, 300.0, 40 << 30)])
def test_recommend_stream_chunk_matches_reference(n_rows, d, m, bs_avg, budget, tier):
    for frac in (0.25, 0.5):
        want = ref_recommend(n_rows, d, m, bs_avg, tier=tier, budget=budget, frac=frac)
        got = recommend_stream_chunk(n_rows, d, m, bs_avg, tier=tier, budget=budget, frac=frac)
        assert got == want


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    """Both packages' autotune at the reference test's size, records saved."""
    x, y = skewed_data(seed=5, n_clusters=5)
    kw = dict(bucket_grid=(0, 2), tiers=("bf16", "f64"), repeats=1)
    ref_dir = str(tmp_path_factory.mktemp("ref_rec"))
    port_dir = str(tmp_path_factory.mktemp("port_rec"))
    want = ref_autotune(x, y, RefConfig(n_blocks=10, m=12), params=PAR, save_dir=ref_dir, **kw)
    got = autotune_loglik(x, y, SBVConfig(n_blocks=10, m=12), params=P, save_dir=port_dir,
                          device="cpu", **kw)
    return x, y, want, got, ref_dir, port_dir


def test_autotune_candidates_match_reference(tuned):
    _, _, want, got, _, _ = tuned
    assert got.histogram == want.histogram
    assert len(got.candidates) == len(want.candidates) == 4  # 2 levels x 2 tiers
    for g, w in zip(got.candidates, want.candidates):
        assert (g["n_buckets"], g["precision"]) == (w["n_buckets"], w["precision"])
        assert g["tiers"] == w["tiers"]
        assert g["occupancy"] == w["occupancy"]
        assert g["time_s"] > 0
    # Knobs that do not depend on the timing agree too.
    assert (got.bs_mult, got.m_mult, got.backend) == (want.bs_mult, want.m_mult, want.backend)
    assert {k: v for k, v in got.meta.items() if k != "device"} == \
        {k: v for k, v in want.meta.items() if k != "device"}
    assert got.meta["device"] == "cpu"


def test_autotune_record_reproduces_choices(tuned):
    """The persisted record reloads to the same dict and drives ``fit_sbv``
    without measuring again (the reference test's contract)."""
    x, y, _, got, _, port_dir = tuned
    back = TuningRecord.load(port_dir)
    assert back.to_dict() == got.to_dict()
    assert as_record(port_dir).to_dict() == got.to_dict()
    res = fit_sbv(x, y, SBVConfig(n_blocks=10, m=12), inner_steps=3, outer_rounds=1,
                  tuning=port_dir, device="cpu")
    losses = [h[2] for h in res.history]
    assert losses[-1] < losses[0]


def test_records_cross_load_both_ways(tuned):
    _, _, want, got, ref_dir, port_dir = tuned
    assert TuningRecord.load(ref_dir).to_dict() == want.to_dict()
    assert RefRecord.load(port_dir).to_dict() == got.to_dict()
    with open(os.path.join(port_dir, "tuning_record.json")) as f:
        assert json.load(f) == got.to_dict()


def _record(**kw):
    base = dict(n_buckets=2, precision="f64", backend="pallas", stream_chunk=None,
                bucket_tiers=["f64", "f64"])
    base.update(kw)
    return base


def test_reference_backend_names_read_as_auto(tmp_path):
    """A reference record naming its TPU kernels runs the port's kernel
    route; saved again by the port, the record is unchanged."""
    RefRecord(**_record()).save(str(tmp_path / "ref"))
    rec = TuningRecord.load(str(tmp_path / "ref"))
    assert rec.backend == "pallas"
    assert [port_backend(b) for b in ("pallas", "pallas_tiled", "auto", "ref", None)] == \
        ["auto", "auto", "auto", "ref", None]
    assert tuned_config(rec).backend == "auto"
    rec.save(str(tmp_path / "port"))
    assert RefRecord.load(str(tmp_path / "port")).to_dict() == \
        RefRecord.load(str(tmp_path / "ref")).to_dict()


def test_fit_with_record_equals_explicit_knobs(tmp_path):
    """``fit_sbv(tuning=)`` is bitwise the fit with the record's knobs
    (n_buckets, and precision as a probing policy), and an explicit
    argument wins over the record."""
    from repro_torch.core.buckets import PrecisionPolicy

    x, y = skewed_data(seed=5, n_clusters=5)
    cfg = SBVConfig(n_blocks=10, m=12)
    rec = TuningRecord(**_record(precision="f32", backend="ref"))
    kw = dict(inner_steps=2, outer_rounds=1, device="cpu")
    got = fit_sbv(x, y, cfg, tuning=rec, **kw)
    want = fit_sbv(x, y, cfg, n_buckets=2, precision=PrecisionPolicy(tier="f32"),
                   backend="ref", **kw)
    assert got.history == want.history
    assert got.precision_tiers == want.precision_tiers
    for a, b in zip(got.params, want.params):
        assert torch.equal(a, b)
    # Explicit knobs win over the record's.
    over = fit_sbv(x, y, cfg, tuning=rec, n_buckets=3, precision="f64", **kw)
    plain = fit_sbv(x, y, cfg, n_buckets=3, precision="f64", backend="ref", **kw)
    assert over.history == plain.history


def test_predict_with_record_equals_explicit_knobs():
    x, y = skewed_data(seed=5, n_clusters=5)
    xt = np.random.default_rng(3).uniform(x.min(0), x.max(0), size=(90, 3))
    rec = _record(precision="bf16", backend="pallas_tiled", n_buckets=3,
                  bucket_tiers=["bf16"] * 3)
    kw = dict(bs_pred=8, m_pred=20, n_sims=2, device="cpu", chunk_size=40)
    got = predict_sbv(P, x, y, xt, tuning=rec, **kw)
    want = predict_sbv(P, x, y, xt, n_buckets=3, precision="bf16", backend="auto", **kw)
    for f in ("mean", "var"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # The "bf16" label over buckets the probe settled at f64 predicts in f64.
    demoted = predict_sbv(P, x, y, xt, tuning=dict(rec, bucket_tiers=["bf16", "f64", "bf16"]),
                          **kw)
    f64 = predict_sbv(P, x, y, xt, n_buckets=3, **kw)
    np.testing.assert_array_equal(demoted.mean, f64.mean)
    over = predict_sbv(P, x, y, xt, tuning=rec, n_buckets=2, precision="f64", **kw)
    plain = predict_sbv(P, x, y, xt, n_buckets=2, **kw)
    np.testing.assert_array_equal(over.mean, plain.mean)


def test_tuned_config_fills_unset_knobs_and_overrides_win():
    cfg = tuned_config(_record(n_buckets=4, precision="bf16", stream_chunk=8192,
                               bucket_tiers=["bf16"] * 4))
    assert (cfg.n_buckets, cfg.precision, cfg.stream_chunk, cfg.backend) == \
        (4, "bf16", 8192, "auto")
    assert cfg.dtype == np.float32  # a narrow tier packs at its accumulation width
    cfg = tuned_config(_record(n_buckets=4, precision="bf16", bucket_tiers=["bf16", "f32"]))
    assert cfg.precision == "f32"  # the widest tier the buckets settled at
    # n_buckets=0 asks for the uniform layout; None would leave it to the record.
    cfg = tuned_config(_record(), n_buckets=0, backend="ref", bs_pred=8)
    assert (cfg.n_buckets, cfg.backend, cfg.bs_pred, cfg.precision) == (0, "ref", 8, None)
    assert tuned_config(_record(), n_buckets=None).n_buckets == 2
    assert PipelineConfig(precision="f64").precision is None


def test_fit_gp_cli_autotune_then_record(tmp_path, capsys):
    """``fit_gp --autotune --tuning-record DIR`` measures and saves a record;
    ``--tuning-record DIR`` alone starts a fit from it."""
    from repro_torch.launch import fit_gp

    rec_dir = str(tmp_path / "rec")
    base = ["--n", "600", "--blocks", "12", "--m", "8", "--inner-steps", "2",
            "--outer-rounds", "1", "--device", "cpu", "--m-pred", "16"]
    fit_gp.main(base + ["--autotune", "--tuning-record", rec_dir])
    out = capsys.readouterr().out
    assert "[autotune] K=" in out and "[fit_gp] autotune" in out
    rec = TuningRecord.load(rec_dir)
    assert len(rec.candidates) == 12 and rec.meta["device"] == "cpu"
    res, mspe = fit_gp.main(base + ["--tuning-record", rec_dir])
    assert np.isfinite(mspe) and len(res.history) == 2
