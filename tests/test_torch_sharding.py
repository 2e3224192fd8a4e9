"""The port's meshes and sharding rules against the JAX package's.

The reference's rules read only a mesh's ``shape`` and ``axis_names`` (as
tests/test_constraints.py's ``FakeMesh`` does), so both packages' specs are
computed for the same device-free meshes: the test mesh (2, 2) and the two
production meshes, (16, 16) and (2, 16, 16). The reference's parameter and
cache trees come from ``jax.eval_shape`` at the mesh's tp, the port's from
a ``TransformerLM`` and a cache on ``meta``; every leaf's spec is compared
entry by entry with the reference's ``PartitionSpec``. Exact equality
throughout.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS, get_config as jget_config  # noqa: E402
from repro.launch.specs import abstract_params as jabstract_params  # noqa: E402
from repro.models.attention import cache_expand_factor as jexpand  # noqa: E402
from repro.models.model import make_empty_cache as jmake_empty_cache  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.sharding.constraints import _resolve as jresolve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.models.attention import cache_expand_factor  # noqa: E402
from repro_torch.models.model import make_empty_cache  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.constraints import _resolve, model_divides  # noqa: E402


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "test": tmesh.make_test_mesh((2, 2)),
    "pod": tmesh.make_production_mesh(),
    "multipod": tmesh.make_production_mesh(multi_pod=True),
}


def _fake(mesh) -> FakeMesh:
    return FakeMesh(dict(mesh.shape))


def _flat_specs(tree) -> dict:
    """{"a/b/c": tuple(spec)} of a reference spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in leaves}


# -- meshes ----------------------------------------------------------------

def test_meshes_match_the_reference_layouts():
    pod, multi = MESHES["pod"], MESHES["multipod"]
    assert pod.axis_names == ("data", "model") and pod.shape == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert str(multi) == "2x16x16" and pod.size == 256
    assert tmesh.make_mesh("2x4").shape == {"data": 2, "model": 4}
    assert tmesh.make_mesh("2x1x8").axis_names == ("pod", "data", "model")
    assert tmesh.make_test_mesh().shape == {"data": 2, "model": 2}
    for bad in ("4", "2xa", "1x2x3x4", "0x2"):
        with pytest.raises(ValueError):
            tmesh.make_mesh(bad)


# -- _resolve and the expansion factor (tests/test_constraints.py) ---------

def test_resolve_reference_cases():
    res = lambda shape, dim, entry: _resolve(FakeMesh(shape), dim, entry)
    assert res({"model": 16}, 64, "model") == "model"
    assert res({"model": 16}, 24, "model") is None
    assert res({"model": 1}, 64, "model") is None
    assert res({"data": 4}, 8, ("pod", "data")) == "data"
    assert res({"data": 4, "model": 2}, 8, ("pod", "data")) == "data"
    assert res({"data": 4, "model": 16}, 8, ("data", "model")) == "data"
    assert res({"data": 4, "model": 2}, 8, ("data", "model")) == ("data", "model")


@pytest.mark.parametrize("seed", range(4))
def test_resolve_matches_reference_and_always_divides(seed):
    """Random (dim, mesh, entry) triples, numpy seeds: the port's pick equals
    the reference's, and its size divides dim and exceeds 1."""
    rng = np.random.default_rng(seed)
    entries = [None, "model", "data", ("pod", "data"), ("pod", "data", "model"),
               ("data", "model"), ("model", "data")]
    for _ in range(200):
        shape = {"pod": int(rng.choice([1, 2, 4])), "data": int(rng.choice([1, 2, 4, 8, 16])),
                 "model": int(rng.choice([1, 2, 4, 8, 16]))}
        if rng.random() < 0.3:
            shape.pop("pod")
        dim = int(rng.integers(1, 4097))
        entry = entries[rng.integers(len(entries))]
        got = _resolve(FakeMesh(shape), dim, entry)
        assert got == jresolve(FakeMesh(shape), dim, entry), (shape, dim, entry)
        if got is not None:
            names = (got,) if isinstance(got, str) else got
            size = int(np.prod([shape[n] for n in names]))
            assert dim % size == 0 and size > 1


def test_model_divides():
    assert model_divides(48, MESHES["pod"]) and not model_divides(40, MESHES["pod"])
    assert model_divides(7, None) and model_divides(7, FakeMesh({"data": 4}))
    assert model_divides(7, FakeMesh({"model": 1}))


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16, 32])
def test_cache_expand_factor_matches_reference(tp):
    for arch in ARCHS:
        assert cache_expand_factor(get_config(arch), tp) == jexpand(jget_config(arch), tp), arch


def test_known_expansion_factors_on_production_mesh():
    expect = {"internlm2-1.8b": 2, "gemma2-9b": 2, "mistral-large-123b": 2, "dbrx-132b": 2,
              "chameleon-34b": 2, "musicgen-large": 1, "zamba2-2.7b": 1, "qwen2-moe-a2.7b": 1,
              "minitron-4b": 1, "rwkv6-3b": 1}
    for arch, r in expect.items():
        assert cache_expand_factor(get_config(arch), 16) == r, arch


# -- the rules ---------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh_name):
    """Every parameter leaf's spec, keyed by its reference path, at the
    mesh's tp (MoE experts padded to it)."""
    mesh = MESHES[mesh_name]
    tp = rules.tp_size(mesh)
    want = _flat_specs(jrules.param_specs(jabstract_params(jget_config(arch), tp), _fake(mesh)))
    got = rules.param_specs(abstract_params(get_config(arch), tp), mesh)
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch, mesh_name):
    """The decode cache's specs at the mesh's tp (expanded K/V heads) for a
    batch the data axes divide and one they do not, at two lengths."""
    mesh = MESHES[mesh_name]
    tp = rules.tp_size(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams, model = jabstract_params(jcfg, tp), abstract_params(cfg, tp)
    for batch, length in ((128, 32_768), (1, 4_096), (6, 1_000)):
        jcache = jax.eval_shape(lambda p: jmake_empty_cache(p, jcfg, batch, length, tp=tp),
                                jparams)
        want = _flat_specs(jrules.cache_specs(jcache, _fake(mesh)))
        cache = make_empty_cache(model, batch, length, tp=tp)
        assert rules.cache_specs(cache, mesh) == want, (batch, length)
        for key, leaf in jcache.items():
            if key != "pos":
                assert tuple(cache[key].shape) == tuple(leaf.shape), key


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_matches_reference(mesh_name):
    mesh = MESHES[mesh_name]
    for b in (1, 2, 4, 6, 32, 128, 256, 512, 1000):
        assert rules.batch_spec(mesh, b) == tuple(jrules.batch_spec(_fake(mesh), b)), b


def test_divisibility_fallbacks():
    """tests/test_launch_specs.py's cases on the (2, 2) mesh."""
    mesh = MESHES["test"]
    specs = rules.param_specs({"wq": (4, 6, 10), "odd": (7,)}, mesh)
    assert specs == {"wq": (None, "data", "model"), "odd": (None,)}
    assert rules.param_specs({"wq": torch.empty(4, 5, 6, device="meta")}, mesh) == {
        "wq": (None, None, "model")}


def test_device_bytes_divide_by_the_named_axes():
    mesh = MESHES["multipod"]
    assert rules.shard_count((None, ("pod", "data"), "model"), mesh) == 512
    assert rules.device_bytes((88, 12288, 1536), 2, (None, ("pod", "data"), "model"),
                              mesh) == 88 * 12288 * 1536 * 2 // 512
    assert rules.device_bytes((7,), 4, (None,), mesh) == 28
