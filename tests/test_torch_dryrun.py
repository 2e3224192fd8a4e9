"""The port's parameter counts, FLOP model and dry run against the JAX
package's, on the CPU.

The reference's parameter, cache and train-state trees come from
``jax.eval_shape`` and its specs from ``repro.sharding.rules`` on a
device-free mesh (its rules read only the mesh's shape and axis names), so
the bytes a device holds under them are reckoned here by plain arithmetic
and held exactly against what ``python -m repro_torch.launch.dryrun``
records; counts and model FLOPs are held exactly too. The FLOP count's
extension from one and two layer units to the full depth is held against
the count at full depth.
"""
import json
import math

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.hlo_analysis import model_flops as jmodel_flops  # noqa: E402
from repro.configs import ARCHS, SHAPES, applicable as japplicable  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import param_count as jpc  # noqa: E402
from repro.launch.specs import SBV_GP_SHAPES as JSBV  # noqa: E402
from repro.launch.specs import abstract_params as jabstract_params  # noqa: E402
from repro.models.model import make_empty_cache as jmake_empty_cache  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.analysis import DEFAULT_HW, model_flops  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import param_count as tpc  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import SBV_GP_SHAPES, abstract_params  # noqa: E402


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"pod": make_production_mesh(), "1x1": make_mesh("1x1")}


def _dev_bytes(tree, specs, mesh, per_elem=None) -> int:
    """Bytes one device holds of ``tree`` under ``specs``: each leaf's bytes
    over the product of the sizes of the axes its spec names."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for entry in spec:
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= mesh.shape[ax]
        size = per_elem(leaf.dtype) if per_elem else leaf.dtype.itemsize
        total += math.prod(leaf.shape) * size // n
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert tpc.param_count(cfg) == jpc.param_count(jcfg)
    assert tpc.active_param_count(cfg) == jpc.active_param_count(jcfg)
    assert tpc.total_param_count(cfg) == jpc.total_param_count(jcfg)


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_model_size_matches_reference_tree(arch, tp):
    """The meta-built ``TransformerLM`` holds as many parameters as the
    reference's ``eval_shape`` tree at the same tp (padded experts)."""
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(
        jabstract_params(jget_config(arch), tp)))
    assert sum(p.numel() for p in abstract_params(get_config(arch), tp).parameters()) == want


def test_model_flops_match_reference():
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert model_flops(get_config(arch), shape) == jmodel_flops(jget_config(arch),
                                                                        shape), (arch, name)


@pytest.mark.parametrize("arch,over", [("internlm2-1.8b", dict(n_layers=5)),
                                       ("gemma2-9b", dict(n_layers=6)),
                                       ("qwen2-moe-a2.7b", dict(n_layers=3)),
                                       ("zamba2-2.7b", dict(n_layers=6)),
                                       ("rwkv6-3b", dict(n_layers=3))])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_extend_linearly_in_depth(arch, over, kind):
    """A step counted at one and two layer units and extended equals the
    step counted at full depth (reduced widths, 2 x 64 tokens)."""
    cfg = get_config(arch).reduced(**over)
    shape = ShapeSpec("t", 64, 2, kind)
    mesh = MESHES["1x1"]
    full = dryrun.lm_step_flops(cfg, shape, mesh, full=True)
    assert full > 0 and dryrun.lm_step_flops(cfg, shape, mesh) == full


def _run(tmp_path, argv) -> dict:
    out = tmp_path / "dry.json"
    res = dryrun.main(argv + ["--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    return res


def test_serving_cells_bytes_match_reference_arithmetic(tmp_path):
    """Decode and the long-context skip on the pod mesh and one card: the
    parameter and cache bytes per device equal the arithmetic on the
    reference's trees and specs at the mesh's tp (r = 2 for internlm2 at
    tp = 16; qwen2-moe's 60 experts padded to 64)."""
    archs = ["internlm2-1.8b", "qwen2-moe-a2.7b"]
    res = _run(tmp_path, sum((["--arch", a] for a in archs), []) + [
        "--shape", "decode_32k", "--shape", "long_500k", "--mesh", "pod", "--mesh", "1x1"])
    for arch in archs:
        jcfg = jget_config(arch)
        ok, why = japplicable(jcfg, "long_500k")
        assert not ok and res[f"{arch}|long_500k|-"]["skipped"] == why
        shape = SHAPES["decode_32k"]
        for name, mesh in MESHES.items():
            fake = FakeMesh(dict(mesh.shape))
            tp = mesh.shape["model"]
            params = jabstract_params(jcfg, tp)
            cache = jax.eval_shape(lambda p: jmake_empty_cache(
                p, jcfg, shape.global_batch, shape.seq_len, tp=tp), params)
            cache = {k: v for k, v in cache.items() if k != "pos"}
            p_dev = _dev_bytes(params, jrules.param_specs(params, fake), fake)
            c_dev = _dev_bytes(cache, jrules.cache_specs(cache, fake), fake)
            got = res[f"{arch}|decode_32k|{name}"]
            assert (got["param_bytes"], got["cache_bytes"]) == (p_dev, c_dev), name
            assert got["peak_memory"] == p_dev + c_dev
            assert got["fits"] == (p_dev + c_dev <= 80e9) and got["hw"] == DEFAULT_HW.name
            assert got["n_devices"] == mesh.size and got["flops"] > got["model_flops"] > 0


def test_training_cell_bytes_match_reference_arithmetic(tmp_path):
    """A training cell: params, then grads and f32 moments (12 B a bf16
    parameter in all) and the functional Adam's 22 B at the update, per
    device under the reference's param specs."""
    res = _run(tmp_path, ["--arch", "qwen2-moe-a2.7b", "--shape", "train_4k", "--mesh", "pod",
                          "--mesh", "1x1"])
    for name, mesh in MESHES.items():
        fake = FakeMesh(dict(mesh.shape))
        params = jabstract_params(jget_config("qwen2-moe-a2.7b"), mesh.shape["model"])
        specs = jrules.param_specs(params, fake)
        p_dev = _dev_bytes(params, specs, fake)
        state = _dev_bytes(params, specs, fake, lambda dt: 2 * dt.itemsize + 8)
        update = _dev_bytes(params, specs, fake, lambda dt: 3 * dt.itemsize + 16)
        got = res[f"qwen2-moe-a2.7b|train_4k|{name}"]
        assert got["param_bytes"] == p_dev and got["state_bytes"] == state - p_dev
        assert got["extra"]["adam_state_bytes"] == state
        assert got["peak_memory"] == got["extra"]["adam_update_bytes"] == update
        assert 0 < got["useful_ratio"] < 1
    n = sum(math.prod(a.shape) for a in jax.tree.leaves(params))
    assert res["qwen2-moe-a2.7b|train_4k|1x1"]["extra"]["totals"]["adam_update"] == 22 * n + sum(
        6 * math.prod(a.shape) for a in jax.tree.leaves(params) if a.dtype == jnp.float32)


def test_sbv_gp_cells_match_reference_shapes(tmp_path):
    """Both SBV GP shapes on both meshes: the blocks padded to the device
    count and split over every device; the model FLOPs the reference's
    analytic count. (The reference's ``sbv_gp_cell`` builds the same
    ShapeDtypeStructs; its shapes are copied, not imported.)"""
    assert SBV_GP_SHAPES == JSBV
    res = _run(tmp_path, ["--arch", "sbv-gp", "--mesh", "pod", "--mesh", "1x1"])
    for shape_name, spec in JSBV.items():
        n, d, bs, m = spec["n"], spec["d"], spec["bs"], spec["m"]
        for name, mesh in MESHES.items():
            bc = -(-(n // bs) // mesh.size) * mesh.size
            per_block = bs * d * 8 + bs * 8 + bs + m * d * 8 + m * 8 + m
            got = res[f"sbv-gp|{shape_name}|{name}"]
            assert got["state_bytes"] == got["peak_memory"] == bc * per_block // mesh.size
            assert got["model_flops"] == (n / bs) * (m**3 / 3 + bs**3 / 3 + m * m * bs
                                                     + m * bs * bs) * 2.0
            assert got["flops"] > 0


def test_resume_keeps_finished_cells(tmp_path, monkeypatch):
    out = tmp_path / "dry.json"
    argv = ["--arch", "internlm2-1.8b", "--shape", "decode_32k", "--mesh", "1x1",
            "--out", str(out)]
    first = dryrun.main(argv)
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: pytest.fail("cell run again"))
    assert dryrun.main(argv + ["--resume"]) == first
