"""Fused SBV block prediction: the CUDA kernel and its plain version.

``sbv_predict_blocks`` is the counterpart of ``sbv_predict_pallas`` and
``sbv_predict_tiled`` (src/repro/kernels/sbv_predict.py): per-block
conditional means and variances, each (bc, bs). The CUDA kernel takes any
bs and m, so the tiled entry point's padding contract holds trivially: the
caller's shapes are the kernel's shapes. On CPU tensors the wrapper runs
the plain version, ``repro_torch.core.predict.block_predict``.
"""
from __future__ import annotations

import torch

from . import _build
from .sbv_loglik import NU_CODES, _check_operands, _grid


def sbv_predict_plain(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                      nu: float = 3.5):
    """The plain torch version of the kernel: ``(mu, var)``, each (bc, bs)."""
    from repro_torch.core.predict import block_predict

    return block_predict(beta, sigma2, nugget, q_x, q_mask.bool(), nn_x, nn_y,
                         nn_mask.bool(), nu=nu)


def sbv_predict_cuda(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                     nu: float = 3.5):
    """Launch the fused predict kernel on CUDA tensors: ``(mu, var)``."""
    dtype = nn_y.dtype
    bc, bs, d = q_x.shape
    m = nn_x.shape[1]
    if q_mask.shape != (bc, bs) or nn_x.shape != (bc, m, d) or nn_y.shape != (bc, m) \
            or nn_mask.shape != (bc, m):
        raise ValueError("sbv_predict: inconsistent packed shapes")
    if nu not in NU_CODES:
        raise ValueError(f"sbv_predict: unsupported nu={nu}")
    cv = lambda t: t.to(dtype).contiguous()
    ops = dict(q_x=cv(q_x), q_mask=cv(q_mask), nn_x=cv(nn_x), nn_y=cv(nn_y),
               nn_mask=cv(nn_mask))
    device = _check_operands("sbv_predict", dtype, ops)
    beta = torch.as_tensor(beta).to(device=device, dtype=dtype).reshape(d).contiguous()
    scal = torch.stack([torch.as_tensor(sigma2).to(device=device, dtype=dtype).reshape(()),
                        torch.as_tensor(nugget).to(device=device, dtype=dtype).reshape(())])
    mu = torch.empty(bc, bs, dtype=dtype, device=device)
    var = torch.empty(bc, bs, dtype=dtype, device=device)
    if bc == 0 or bs == 0:
        return mu, var
    lib = _build.load("sbv_predict")
    f64 = dtype == torch.float64
    with torch.cuda.device(device):
        grid = _grid(lib, "sbv_predict", bc, device, bs, m, d, int(f64))
        scratch = torch.empty(grid * lib.sbv_predict_scratch_per_cta(bs, m), dtype=dtype,
                              device=device)
        fn = lib.sbv_predict_f64 if f64 else lib.sbv_predict_f32
        err = fn(beta.data_ptr(), scal.data_ptr(), ops["q_x"].data_ptr(),
                 ops["q_mask"].data_ptr(), ops["nn_x"].data_ptr(), ops["nn_y"].data_ptr(),
                 ops["nn_mask"].data_ptr(), mu.data_ptr(), var.data_ptr(), scratch.data_ptr(),
                 bc, bs, m, d, NU_CODES[nu], grid,
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "sbv_predict")
    _build.LAUNCHES["sbv_predict"] += 1
    return mu, var


def sbv_predict_blocks(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                       nu: float = 3.5):
    """``(mu, var)`` per block: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q_x.is_cuda:
        return sbv_predict_cuda(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask, nu=nu)
    return sbv_predict_plain(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask, nu=nu)
