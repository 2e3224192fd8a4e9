"""Meta-device stand-ins and step builders for every dry-run cell: the
counterpart of ``repro.launch.specs``.

Each cell builder returns ``(step_fn, args, specs)``: the step of the
cell's kind (``training.train_step.make_train_step``, ``training.serve.
make_prefill_step`` or ``make_decode_step``), its arguments as tensors on
the ``meta`` device (shapes and dtypes, no storage), and their specs under
the cell's mesh from ``repro_torch.sharding`` (a dict by argument name;
prefill also gives the specs of the cache it returns). The reference builds
``ShapeDtypeStruct``s and ``NamedSharding``s for ``jax.jit(...).lower()``;
the port runs the step itself on ``meta`` (``launch.dryrun``). The model is
built at ``tp = tp_size(mesh)``: padded experts and, for the decode cache,
``cache_expand_factor(cfg, tp)`` copies of each KV head.

The SBV GP runtime is an extra target ("sbv-gp"): one gradient step of the
block-Vecchia likelihood at the paper's largest workloads, its blocks
sharded over all mesh axes flattened into the paper's P workers.

``*_bytes`` reckon what a tensor set takes in all and on one device of the
mesh under its specs: each leaf's bytes divided by the product of the axis
sizes its spec shards over.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import reference_leaves
from repro_torch.models.attention import cache_expand_factor
from repro_torch.models.model import TransformerLM
from repro_torch.models.transformer import init_cache, padded_experts
from repro_torch.sharding.rules import (batch_spec, cache_specs, device_bytes, param_specs,
                                        tp_size)

META = torch.device("meta")


def abstract_params(cfg, tp: int = 1) -> TransformerLM:
    """A ``TransformerLM`` on ``meta`` (experts padded for ``tp``)."""
    return TransformerLM(cfg, device=META, tp=tp)


def _tree_bytes(leaves: dict, specs: dict, mesh, per_elem=None) -> tuple[int, int]:
    """(total, per-device) bytes of ``leaves`` ({key: (shape, dtype)}),
    ``per_elem(dtype)`` bytes per element (default: the dtype's size)."""
    total = dev = 0
    for key, (shape, dtype) in leaves.items():
        size = per_elem(dtype) if per_elem else dtype.itemsize
        n = 1
        for s in shape:
            n *= s
        total += n * size
        dev += device_bytes(shape, size, specs[key], mesh)
    return total, dev


def param_bytes(model: TransformerLM, mesh) -> tuple[int, int]:
    """(total, per-device) bytes of the model's parameters under
    ``param_specs``."""
    return _tree_bytes(reference_leaves(model), param_specs(model, mesh), mesh)


def adam_bytes(model: TransformerLM, mesh) -> dict:
    """The functional Adam's bytes, in all and per device: ``state`` holds
    params, grads (the params' dtype) and f32 moments (12 B a bf16
    parameter); ``update`` adds the new params and moments that
    ``optim.adam_update`` builds beside the old (22 B)."""
    leaves, specs = reference_leaves(model), param_specs(model, mesh)
    state = _tree_bytes(leaves, specs, mesh, lambda dt: 2 * dt.itemsize + 8)
    update = _tree_bytes(leaves, specs, mesh, lambda dt: 3 * dt.itemsize + 16)
    return {"state": state, "update": update}


def cache_bytes(cache: dict, mesh) -> tuple[int, int]:
    """(total, per-device) bytes of a decode cache under ``cache_specs``."""
    leaves = {k: (tuple(v.shape), v.dtype) for k, v in cache.items() if torch.is_tensor(v)}
    return _tree_bytes(leaves, cache_specs(cache, mesh), mesh)


def meta_cache(cfg, batch: int, cache_len: int, tp: int, dtype) -> dict:
    """The decode cache a prefill of ``cache_len`` builds (or ``init_cache``
    makes), on ``meta``."""
    return init_cache(cfg, batch, cache_len, dtype, META, tp)


def mesh_line(cfg, mesh, model: TransformerLM, cache: dict | None = None,
              train: bool = False) -> str:
    """The CLIs' header: the mesh, its tp, the padded expert count, the
    cache factor r, and per-device bytes reckoned from the specs."""
    tp = tp_size(mesh)
    gb = lambda b: f"{b / 1e9:.4g} GB"
    p_all, p_dev = param_bytes(model, mesh)
    parts = [f"params {gb(p_dev)} of {gb(p_all)}"]
    if cache is not None:
        c_all, c_dev = cache_bytes(cache, mesh)
        parts.append(f"cache {gb(c_dev)} of {gb(c_all)}")
    if train:
        ad = adam_bytes(model, mesh)
        parts.append(f"params, grads and Adam moments {gb(ad['state'][1])} "
                     f"({gb(ad['update'][1])} at the update)")
    experts = (f"{cfg.n_experts} -> {padded_experts(cfg, tp)}" if cfg.n_experts else "none")
    axes = ", ".join(f"{a}={n}" for a, n in mesh.shape.items())
    return (f"[mesh] {mesh} ({axes}) on one device: tp={tp}, experts {experts}, cache factor "
            f"r={cache_expand_factor(cfg, tp)}; "
            f"per device of the mesh (reckoned from the specs): " + ", ".join(parts))


def _tokens(b: int, s: int) -> torch.Tensor:
    return torch.empty(b, s, dtype=torch.int32, device=META)


def train_cell(cfg, shape, mesh):
    """One ``make_train_step(cfg, tp)`` step on a ``(global_batch,
    seq_len)`` batch."""
    from repro_torch.training.train_step import make_train_step, train_state_init

    tp = tp_size(mesh)
    model = abstract_params(cfg, tp)
    state = train_state_init(model)
    tok = _tokens(shape.global_batch, shape.seq_len)
    pspecs = param_specs(model, mesh)
    bspec = batch_spec(mesh, shape.global_batch)
    specs = {"state": {"params": pspecs, "opt": {"step": (), "mu": pspecs, "nu": pspecs},
                       "step": ()},
             "tokens": bspec, "labels": bspec}
    return make_train_step(cfg, tp=tp), (state, tok, tok), specs


def prefill_cell(cfg, shape, mesh):
    """A ``seq_len`` prompt into a ``seq_len`` cache."""
    from repro_torch.training.serve import make_prefill_step

    tp = tp_size(mesh)
    model = abstract_params(cfg, tp)
    b = shape.global_batch
    bspec = batch_spec(mesh, b)
    cache = meta_cache(cfg, b, shape.seq_len, tp, model.dtype)
    specs = {"params": param_specs(model, mesh), "tokens": bspec,
             "logits": (bspec[0], None), "cache": cache_specs(cache, mesh)}
    return make_prefill_step(cfg, shape.seq_len, tp=tp), (model, _tokens(b, shape.seq_len)), specs


def decode_cell(cfg, shape, mesh):
    """One token against a ``seq_len``-deep cache."""
    from repro_torch.training.serve import make_decode_step

    tp = tp_size(mesh)
    model = abstract_params(cfg, tp)
    b = shape.global_batch
    cache = meta_cache(cfg, b, shape.seq_len, tp, model.dtype)
    bspec = batch_spec(mesh, b)
    specs = {"params": param_specs(model, mesh), "tokens": bspec,
             "cache": cache_specs(cache, mesh), "logits": (bspec[0], None)}
    return make_decode_step(cfg, tp=tp), (model, _tokens(b, 1), cache), specs


# ------------------------------------------------------------- SBV GP ----

SBV_GP_SHAPES = {
    # paper workloads: MetaRVM 50M pts d=10 (bs=100, m=400: paper's largest
    # accuracy config), and the Fig.9 strong-scaling 128M-point run.
    "fit_50m": dict(n=50_000_000, d=10, bs=100, m=400),
    "fit_128m": dict(n=128_000_000, d=10, bs=100, m=200),
}


def sbv_gp_cell(shape_name: str, mesh, variant: str = "magma"):
    """One MLE gradient step of the SBV likelihood (its value only for a
    ``*_fwd`` variant) over ``bc`` blocks, padded to a multiple of the
    mesh's device count and sharded over every axis.

    variant: 'magma' = the chain chol -> solve -> Schur -> chol
    (``core.vecchia.batched_block_loglik``); 'joint' = one joint Cholesky
    (``batched_block_loglik_joint``); 'joint_remat' = joint under
    checkpointed slices of blocks (``batched_block_loglik_joint_remat``)."""
    from repro_torch.core import vecchia
    from repro_torch.core.kernels_math import KernelParams

    spec = SBV_GP_SHAPES[shape_name]
    n, d, bs, m = spec["n"], spec["d"], spec["bs"], spec["m"]
    n_dev = mesh.size
    bc = -(-(n // bs) // n_dev) * n_dev
    fwd_only = variant.endswith("_fwd")
    base = variant[:-4] if fwd_only else variant
    loglik_fn = {"magma": vecchia.batched_block_loglik,
                 "joint": vecchia.batched_block_loglik_joint,
                 "joint_remat": vecchia.batched_block_loglik_joint_remat}.get(base)
    if loglik_fn is None:
        raise ValueError(variant)
    f64 = dict(dtype=torch.float64, device=META)
    params = KernelParams(log_sigma2=torch.empty((), **f64), log_beta=torch.empty(d, **f64),
                          log_nugget=torch.empty((), **f64))
    args = (params,
            torch.empty(bc, bs, d, **f64), torch.empty(bc, bs, **f64),
            torch.empty(bc, bs, dtype=torch.bool, device=META),
            torch.empty(bc, m, d, **f64), torch.empty(bc, m, **f64),
            torch.empty(bc, m, dtype=torch.bool, device=META))

    def step(params, *blocks):
        if fwd_only:
            with torch.no_grad():
                return -loglik_fn(params, *blocks, nu=3.5) / n, params
        leaves = tuple(t.detach().requires_grad_() for t in params)
        loss = -loglik_fn(KernelParams(*leaves), *blocks, nu=3.5) / n
        return loss.detach(), KernelParams(*torch.autograd.grad(loss, leaves))

    blocks = (tuple(mesh.axis_names),)
    specs = {"params": ((), (None,), ()),
             "blocks": tuple(blocks + (None,) * (a.dim() - 1) for a in args[1:])}
    return step, args, specs


# ------------------------------------------------------------ registry ----

CELLS = {"train": train_cell, "prefill": prefill_cell, "decode": decode_cell}


def build_cell(arch: str, shape_name: str, mesh, **opts):
    """(arch, shape, mesh) -> (step_fn, args, specs)."""
    if arch == "sbv-gp":
        return sbv_gp_cell(shape_name, mesh, **opts)
    shape = SHAPES[shape_name]
    return CELLS[shape.kind](get_config(arch), shape, mesh)
