"""Mamba-2 (SSD) block: the chunked state-space dual form. The counterpart
of ``repro.models.ssm``.

Recurrence (per head h, head dim P, state N):
    h_t = a_t * h_{t-1} + (dt_t x_t) B_t^T        a_t = exp(-exp(A_log) dt_t)
    y_t = C_t h_t + D x_t
It runs in chunks of ``_CHUNK`` = 128 steps, as the reference's scan does,
with a zero-padded ragged tail (zero ``xbar``, B, C and log-decay: exact
no-ops on the state) and the state in f32. The reference's simplifications
are kept: one B/C group, the short causal conv on x only, the gated norm as
``rms_norm(y) * silu(z)``.

The port evaluates every chunk at once where a term does not depend on the
carried state (the cumulative log-decay, C B^T, the intra-chunk decay and
product, each chunk's contribution to the state) and loops over chunks
only for the carry ``h = contrib + exp(clog_last) * h`` (one ``addcmul`` a
chunk); the inter-chunk term then reads every chunk's incoming state in one
product. The arithmetic is the reference's ``_ssd_chunk``, term by term.
Three points differ on purpose:

* the causal mask is applied before the ``exp`` (``exp(-inf) = 0``): the
  reference takes ``exp`` of the whole (t, s) decay difference, whose
  upper triangle overflows to inf in f32 over a 128-step chunk, and masks
  after it, so its forward is right but its gradient is NaN from 128
  tokens on (ROADMAP fault 9);
* the decay from step s to step t is formed from the segment sum of the
  log-decays over (s, t] (``_segsum``), not as the difference of two
  cumulative sums: the same value, but over 128 steps the cumulative sums
  reach ~90, whose f32 spacing (~8e-6) the difference would carry into
  every decay. With the difference one layer's gradient at S = 256 moves
  by 9.0e-6 of its largest entry between chunks of 128 and 32, with the
  segment sums by 2.9e-7 (tests/_torch_ssm_floor.py);
* the intra-chunk product is formed in two steps, ``(C B^T)[..., None] *
  decay`` and then a batched matmul with ``xbar``, so the (Q, Q, H, P)
  tensor of a naive three-operand einsum never exists.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init_, leaf, linear_weight, rms_norm, rms_norm_split, row_parallel

_CHUNK = 128


class Mamba2(nn.Module):
    """The reference's leaves: ``wz``, ``wx`` (d, d_inner), ``wB``, ``wC``
    (d, N), ``wdt`` (d, H), ``dt_bias``, ``A_log``, ``D_skip`` (H,) f32,
    ``conv_w`` (K, d_inner), ``norm`` (d_inner,) f32, ``wo`` (d_inner, d).
    The matrices and ``conv_w`` take ``dtype``."""

    shard = None

    def __init__(self, cfg, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=torch.float32,
                                                      device=device))
        self.wz = linear_weight(d, di, dtype, device)
        self.wx = linear_weight(d, di, dtype, device)
        self.wB = linear_weight(d, n, dtype, device)
        self.wC = linear_weight(d, n, dtype, device)
        self.wdt = linear_weight(d, h, dtype, device)
        self.dt_bias = f32(h)
        self.A_log = f32(h)
        self.D_skip = f32(h)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv, di, dtype=dtype, device=device))
        self.norm = f32(di)
        self.wo = linear_weight(di, d, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``mamba2_init``: dense draws, ``dt_bias`` and
        ``A_log`` zero (A = -1), ``D_skip`` one, ``conv_w`` normal * 0.2,
        ``norm`` zero, ``wo`` at ``d_inner ** -0.5``."""
        for w in (self.wz, self.wx, self.wB, self.wC, self.wdt):
            dense_init_(w, generator)
        dense_init_(self.conv_w, generator, scale=0.2)
        dense_init_(self.wo, generator, scale=self.wo.shape[0] ** -0.5)
        with torch.no_grad():
            self.dt_bias.zero_()
            self.A_log.zero_()
            self.D_skip.fill_(1.0)
            self.norm.zero_()


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by K shifted adds: x (B, S, C), w (K, C) ->
    (B, S, C) in x's dtype. The taps are summed in f32 and rounded once, as
    XLA's fused elementwise pass evaluates the reference's shifted adds;
    decode runs this same function over its K-token window, so the two
    agree bit for bit."""
    k, s = w.shape[0], x.shape[1]
    xf, wf = x.float(), w.float()
    out = xf * wf[k - 1]
    for i in range(1, k):
        out = out + F.pad(xf, (0, 0, i, 0))[:, :s] * wf[k - 1 - i]
    return out.to(x.dtype)


def conv_tail(xp: torch.Tensor, k: int) -> torch.Tensor:
    """The decode cache's conv window after a prefill: the last ``k``
    positions of the conv input ``x @ wx`` (B, S, C), zero-padded in front
    when S < k."""
    s = xp.shape[1]
    return xp[:, s - k:] if s >= k else F.pad(xp, (0, 0, k - s, 0))


def _carry(contrib: torch.Tensor, decay: torch.Tensor, state: torch.Tensor):
    """The state carried across chunks: ``state = contrib[:, c] + decay[:,
    c] * state`` for each chunk c in order. contrib (B, C, H, X, Y), decay
    broadcastable to it, state (B, H, X, Y). Returns (the state entering
    each chunk (B, C, H, X, Y), the final state)."""
    prevs = []
    for c in range(contrib.shape[1]):
        prevs.append(state)
        state = torch.addcmul(contrib[:, c], decay[:, c], state)
    return torch.stack(prevs, 1), state


def _segsum(loga: torch.Tensor) -> torch.Tensor:
    """loga (..., Q) -> (..., Q, Q) with [t, s] = sum of loga over (s, t]
    for s <= t (0 on the diagonal) and -inf above it."""
    q = loga.shape[-1]
    ones = torch.ones(q, q, dtype=torch.bool, device=loga.device)
    seg = torch.cumsum(loga[..., :, None].expand(*loga.shape, q)
                       .masked_fill(~ones.tril(-1), 0.0), dim=-2)
    return seg.masked_fill(~ones.tril(), float("-inf"))


def _ssd_chunks(xbar, bc, cc, loga, state):
    """Every SSD chunk: the reference's ``_ssd_chunk`` scanned over chunks.

    xbar (B, C, Q, H, P) and bc, cc (B, C, Q, N) in the model dtype, loga
    (B, C, Q, H) f32, state (B, H, P, N) f32. Returns (y (B, C, Q, H, P)
    f32, the final state)."""
    loga = loga.transpose(2, 3)                                     # (B, C, H, Q)
    clog = torch.cumsum(loga, dim=-1)
    gt = (cc @ bc.transpose(-1, -2)).float()                        # (B, C, Q, Q) t, s
    dmat = torch.exp(_segsum(loga))                                 # (B, C, H, Q, Q) t, s
    xbar32 = xbar.float().transpose(2, 3)                           # (B, C, H, Q, P)
    # intra-chunk: y[t] = sum_{s<=t} (C_t . B_s) exp(clog_t - clog_s) xbar_s
    y = (gt[:, :, None] * dmat) @ xbar32
    # each chunk's own contribution to the state it passes on, decayed by
    # exp(clog_last - clog_s): the last row of dmat
    wdecay = dmat[..., -1, :]                                       # (B, C, H, Q)
    contrib = (xbar32 * wdecay[..., None]).transpose(-1, -2) @ bc.float()[:, :, None]
    h_prev, state = _carry(contrib, torch.exp(clog[..., -1])[..., None, None], state)
    # inter-chunk: y[t] += exp(clog_t) * C_t h_prev
    y_inter = (cc.float()[:, :, None] @ h_prev.transpose(-1, -2)) * torch.exp(clog)[..., None]
    return (y + y_inter).transpose(2, 3), state


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the sequence axis (dim 1) at its end."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))


def _ssd_region(cfg, x, xh, wB, wC, wdt, dt_bias, A_log, D_skip, norm, state=None):
    """The scan and the gated norm's norm: x (R, S, D) the block's input
    rows, xh (R, S, H, P) their conv output at every head -> (rms_norm(y)
    (R, S, d_inner) in x's dtype, the final SSD state (R, H, P, N) f32)."""
    r, s, _ = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    dtype = x.dtype
    bproj = x @ wB
    cproj = x @ wC
    dt = F.softplus((x @ wdt).float() + dt_bias)                   # (R, S, H)
    loga = -torch.exp(A_log) * dt                                   # (R, S, H) in (-inf, 0)
    xbar = xh * dt[..., None].to(dtype)
    if state is None:
        state = torch.zeros(r, h, p, n, dtype=torch.float32, device=x.device)
    q = min(_CHUNK, s)
    pad = (-s) % q
    if pad:
        xbar, bproj, cproj, loga = (_pad_seq(a, pad) for a in (xbar, bproj, cproj, loga))
    nc = (s + pad) // q
    chunked = lambda a: a.reshape((r, nc, q) + a.shape[2:])
    y, state = _ssd_chunks(chunked(xbar), chunked(bproj), chunked(cproj), chunked(loga), state)
    y = y.reshape(r, s + pad, h, p)[:, :s]
    y = y + D_skip[:, None] * xh.float()
    y = y.reshape(r, s, -1).to(dtype)
    return rms_norm(y, norm, cfg.norm_eps), state


def _split(m: Mamba2) -> bool:
    """Whether the layer is split over 'model': sharded, with the model axis
    dividing d_inner (else ``_fit`` replicates ``wz``, ``wx``, ``conv_w``
    and ``wo`` and the layer runs whole on every model rank)."""
    return m.shard is not None and m.shard.split(m.specs["wx"], 1)


def mamba2_forward(m: Mamba2, x: torch.Tensor, state: torch.Tensor | None = None):
    """x (B, S, D) -> (y (B, S, D), final SSD state (B, H, P, N) f32, conv
    tail (B, K - 1, d_inner)). ``state`` is the initial SSD state; the conv
    tail is what the reference's prefill recomputes as the decode cache's
    conv window (``conv_tail`` of ``x @ wx``). Split over 'model':
    ``_mamba2_forward_sharded``."""
    if _split(m):
        if state is not None:
            raise ValueError("a sharded mamba2 prefill starts from the zero state")
        return _mamba2_forward_sharded(m, x)
    cfg = m.cfg
    b, s, _ = x.shape
    z = x @ leaf(m, "wz")
    xp = x @ leaf(m, "wx")
    xh = F.silu(_causal_conv(xp, m.conv_w)).reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    y, state = _ssd_region(cfg, x, xh, leaf(m, "wB"), leaf(m, "wC"), leaf(m, "wdt"), m.dt_bias,
                           m.A_log, m.D_skip, m.norm, state)
    return (y * F.silu(z)) @ leaf(m, "wo"), state, conv_tail(xp, cfg.ssm_conv - 1)


def _mamba2_forward_sharded(m: Mamba2, x: torch.Tensor):
    """The prefill and training forward on this rank's shards, the
    reference's layout (``FULL_BATCH`` for ``s > 1``, ``ssm.py:104-110``).

    ``wz``, ``wx`` and ``conv_w`` give this rank's channels for all its
    rows (the channel order is head-major, (H, P); a rank's block need not
    be whole heads); the conv output ``xh`` then passes an all-to-all over
    'model' (``all_to_all:ssd``) from channels to rows, after which the
    rank holds rows / tp rows at every channel, so every head whole. ``wB``,
    ``wC`` and ``wdt`` (output whole) are applied to those rows alone, the
    chunk scan and the norm over all of d_inner run on them as on a whole
    model (``_ssd_region``), and the normed ``y`` goes back by the inverse
    all-to-all; the gate ``silu(z)`` meets it there, after the exchange, on
    this rank's channels, before the row-parallel ``wo``. The final state
    passes the inverse all-to-all too where the model axis divides the
    heads (heads over 'model', as ``cache_specs`` lays out the cache), and
    is all-gathered over the rows where it does not (``cache_specs`` then
    keeps it whole); the conv tail already has this rank's channels. Where
    the rows do not divide over 'model' the scan is replicated over it
    instead: ``xh`` is all-gathered over the channels, every rank runs the
    whole scan on its rows and keeps its own channels (and heads).

    Each rank computes only part of the gradient of the leaves read in that
    region (``wB``, ``wC``, ``wdt``, ``dt_bias``, ``A_log``, ``D_skip``,
    ``norm``): they enter through ``ShardContext.partial_leaves``, which
    sums their gradients over 'model' once; the input enters through
    ``to_model``, which sums its partial gradients over 'model'."""
    cfg, sh = m.cfg, m.shard
    b, s, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    heads = h % sh.tp == 0
    x = sh.to_model(x)
    z = x @ leaf(m, "wz")
    xp = x @ leaf(m, "wx")                                          # (B, S, d_inner / tp)
    xh = F.silu(_causal_conv(xp, m.conv_w))
    leaves = sh.partial_leaves(leaf(m, "wB"), leaf(m, "wC"), leaf(m, "wdt"), m.dt_bias, m.A_log,
                               m.D_skip, m.norm, tag="ssd")
    if sh.full_batch(b):
        xh = sh.exchange(xh, 0, 2, "ssd").reshape(b // sh.tp, s, h, p)
        y, state = _ssd_region(cfg, sh.rows(x), xh, *leaves)
        y = sh.exchange(y, 2, 0, "ssd")                             # (B, S, d_inner / tp)
        state = sh.exchange(state, 1, 0, "ssd") if heads else sh.gather_model(state, 0)
    else:
        y, state = _ssd_region(cfg, x, sh.gather_model(xh, 2).reshape(b, s, h, p), *leaves)
        y, state = sh.channels(y), (sh.channels(state, 1) if heads else state)
    y = row_parallel(y * F.silu(z), leaf(m, "wo"), sh)
    return y, state, conv_tail(xp, cfg.ssm_conv - 1)


def mamba2_init_cache(cfg, batch: int, dtype, device=None) -> dict:
    return {"ssd": torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, cfg.ssm_conv - 1, cfg.d_inner, dtype=dtype,
                                device=device)}


def mamba2_decode(m: Mamba2, x: torch.Tensor, cache: dict):
    """One-token step: x (B, 1, D), cache ``{"ssd", "conv"}`` -> (y (B, 1,
    D), new cache). Split over 'model', the cache holds this rank's heads
    (or, where they do not divide the axis, all of them) and conv channels
    (``cache_specs``): the conv runs on the rank's channels, which are
    all-gathered where its heads are not whole, and the gated norm's sum of
    squares is summed over 'model' where they are."""
    cfg, sh = m.cfg, m.shard
    b = x.shape[0]
    p = cfg.ssm_head_dim
    dtype = x.dtype
    split = _split(m)
    heads = split and cfg.ssm_heads % sh.tp == 0
    wz, wx, wo, wB, wC, wdt = (leaf(m, n) for n in ("wz", "wx", "wo", "wB", "wC", "wdt"))
    dt_bias, A_log, D_skip, norm = m.dt_bias, m.A_log, m.D_skip, m.norm
    if split:
        x = sh.to_model(x)
        wB, wC, wdt, dt_bias, A_log, D_skip, norm = sh.partial_leaves(
            wB, wC, wdt, dt_bias, A_log, D_skip, norm, tag="ssd")
    if heads:
        wdt, dt_bias, A_log, D_skip, norm = (sh.channels(t) for t in
                                             (wdt, dt_bias, A_log, D_skip, norm))
    z = x @ wz
    xp = x @ wx                                                     # (B, 1, di)
    window = torch.cat([cache["conv"], xp], dim=1)                  # (B, K, di)
    xr = F.silu(_causal_conv(window, m.conv_w)[:, -1:])
    new_conv = window[:, 1:]

    bproj = x @ wB                                                  # (B, 1, N)
    cproj = x @ wC
    dt = F.softplus((x @ wdt).float() + dt_bias)
    a = torch.exp(-torch.exp(A_log) * dt)                           # (B, 1, H)

    xh = (sh.gather_model(xr, -1) if split and not heads else xr).reshape(b, -1, p)
    xbar = (xh * dt[:, 0, :, None].to(dtype)).float()
    ssd = cache["ssd"] * a[:, 0, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xbar, bproj[:, 0].float())
    y = torch.einsum("bn,bhpn->bhp", cproj[:, 0].float(), ssd)
    y = y + D_skip[None, :, None] * xh.float()
    y = y.reshape(b, 1, -1).to(dtype)
    if not split:
        return (rms_norm(y, norm, cfg.norm_eps) * F.silu(z)) @ wo, {"ssd": ssd, "conv": new_conv}
    if heads:
        y = rms_norm_split(y, norm, cfg.norm_eps, sh, cfg.d_inner)
    else:
        y = sh.channels(rms_norm(y, norm, cfg.norm_eps))
    return row_parallel(y * F.silu(z), wo, sh), {"ssd": ssd, "conv": new_conv}
