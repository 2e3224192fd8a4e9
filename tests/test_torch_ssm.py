"""The port's mamba2 and rwkv6 modules against the JAX package's, on the CPU.

Parameters come from the reference's initialisers (``mamba2_init``,
``rwkv6_init``) with their zero and constant leaves replaced by seeded draws
(so that D, A, the biases, the bonus and the norms all act), and inputs
from numpy seeds. Sequence lengths cover a ragged tail of the chunk (200
and 37 tokens: mamba2's chunk is 128, rwkv6's 16), a single chunk, and
fewer tokens than the conv window (S < K - 1 = 3). Tolerances (f32), each
of the largest entry: 1e-5 for outputs, states and a module's gradients
where the reference's gradient is finite (two implementations of the same
arithmetic, summed in other orders; readings up to 6.2e-6), 1e-5 for the
chunked forms against token-by-token decode loops, and 2e-5 for gradients
through 200 tokens in those two forms (a sum over every step in two
orders; reading 1.4e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-5


def _cfgs(arch):
    return (jconfigs.get_config(arch).reduced(dtype="float32"),
            tconfigs.get_config(arch).reduced(dtype="float32"))


def _randomised(params, seed):
    """The reference's leaves, with every constant leaf (zeros, ones, the
    0.5 shifts, w_base) redrawn around its value so that it matters."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        a = np.array(v, np.float32)
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
        out[k] = a
    return out


def _port(module, params):
    with torch.no_grad():
        for k, v in params.items():
            getattr(module, k).copy_(torch.from_numpy(v))
    return module


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _cfgs("zamba2-2.7b")
    p = _randomised(jssm.mamba2_init(jax.random.key(1), jcfg, jnp.float32), 1)
    return jcfg, p, _port(tssm.Mamba2(tcfg), p)


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg = _cfgs("rwkv6-3b")
    p = _randomised(jrwkv.rwkv6_init(jax.random.key(2), jcfg, jnp.float32), 2)
    return jcfg, p, _port(trwkv.RWKV6(tcfg), p)


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


# -- mamba2 -------------------------------------------------------------------

@pytest.mark.parametrize("s", [200, 128, 37, 2])
def test_mamba2_forward_matches_reference(mamba, s):
    jcfg, p, m = mamba
    x = _x(2, s, jcfg.d_model, s)
    y_j, st_j = jssm.mamba2_forward(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y_t, st_t, tail = tssm.mamba2_forward(m, torch.from_numpy(x))
    _close(y_t, y_j)
    _close(st_t, st_j)
    # The reference's prefill recomputes the conv window as
    # pad(h1 @ wx, front K - 1)[:, s : s + K - 1].
    k = jcfg.ssm_conv - 1
    want = np.pad(x @ p["wx"], ((0, 0), (k, 0), (0, 0)))[:, s:s + k]
    _close(tail, want)


def test_mamba2_forward_continues_from_a_state(mamba):
    jcfg, p, m = mamba
    x = _x(2, 150, jcfg.d_model, 5)
    st0 = np.random.default_rng(6).standard_normal(
        (2, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state)).astype(np.float32)
    y_j, st_j = jssm.mamba2_forward(p, jnp.asarray(x), jcfg, state=jnp.asarray(st0))
    with torch.no_grad():
        y_t, st_t, _ = tssm.mamba2_forward(m, torch.from_numpy(x), torch.from_numpy(st0))
    _close(y_t, y_j)
    _close(st_t, st_j)


def test_mamba2_decode_matches_reference(mamba):
    jcfg, p, m = mamba
    rng = np.random.default_rng(7)
    x = _x(3, 1, jcfg.d_model, 8)
    cache = {"ssd": rng.standard_normal((3, jcfg.ssm_heads, jcfg.ssm_head_dim,
                                         jcfg.ssm_state)).astype(np.float32),
             "conv": rng.standard_normal((3, jcfg.ssm_conv - 1, jcfg.d_inner)).astype(np.float32)}
    y_j, c_j = jssm.mamba2_decode(p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
                                  jcfg)
    with torch.no_grad():
        y_t, c_t = tssm.mamba2_decode(m, torch.from_numpy(x),
                                      {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(y_t, y_j)
    for k in ("ssd", "conv"):
        _close(c_t[k], c_j[k])


@pytest.mark.parametrize("s", [200, 2])
def test_mamba2_chunked_equals_token_loop(mamba, s):
    """The chunked forward against ``mamba2_decode`` token by token from
    an empty cache: every output, the final SSD state and the conv window."""
    jcfg, _, m = mamba
    x = torch.from_numpy(_x(2, s, jcfg.d_model, 9))
    cache = tssm.mamba2_init_cache(m.cfg, 2, torch.float32)
    with torch.no_grad():
        y, st, tail = tssm.mamba2_forward(m, x)
        steps = []
        for t in range(s):
            yt, cache = tssm.mamba2_decode(m, x[:, t:t + 1], cache)
            steps.append(yt)
    _close(y, torch.cat(steps, 1))
    _close(st, cache["ssd"])
    _close(tail, cache["conv"])


def test_mamba2_gradients_match_reference_within_a_chunk(mamba):
    """S = 40 (one chunk, short enough that the reference's unmasked exp
    stays finite at these decays): the gradients of x and of every leaf."""
    jcfg, p, m = mamba
    x = _x(2, 40, jcfg.d_model, 10)
    ct = _x(2, 40, jcfg.d_model, 11)
    fj = lambda p, x: jnp.sum(jssm.mamba2_forward(p, x, jcfg)[0] * ct)
    gp, gx = jax.grad(fj, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x))
    assert np.isfinite(np.asarray(gx)).all()
    xt = torch.from_numpy(x).requires_grad_(True)
    names = list(p)
    y = tssm.mamba2_forward(m, xt)[0]
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), [xt] + [getattr(m, k)
                                                                        for k in names])
    _close(got[0], gx)
    for name, g in zip(names, got[1:]):
        _close(g, gp[name])


def test_mamba2_gradient_is_finite_past_a_chunk(mamba):
    """ROADMAP fault 9 at the module: at S = 200 the reference's gradient
    holds NaN (exp of the unmasked upper triangle overflows, the mask then
    multiplies inf by 0); the port's is finite and equals autograd through
    its own token-by-token decode loop."""
    jcfg, p, m = mamba
    x = _x(1, 200, jcfg.d_model, 12)
    ct = _x(1, 200, jcfg.d_model, 13)
    gx = jax.grad(lambda x: jnp.sum(jssm.mamba2_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, x, jcfg)[0] * ct))(jnp.asarray(x))
    assert not np.isfinite(np.asarray(gx)).all()
    xt = torch.from_numpy(x).requires_grad_(True)
    g_chunk = torch.autograd.grad((tssm.mamba2_forward(m, xt)[0] * torch.from_numpy(ct)).sum(),
                                  [xt, m.A_log])
    cache = tssm.mamba2_init_cache(m.cfg, 1, torch.float32)
    ys = []
    for t in range(200):
        yt, cache = tssm.mamba2_decode(m, xt[:, t:t + 1], cache)
        ys.append(yt)
    g_loop = torch.autograd.grad((torch.cat(ys, 1) * torch.from_numpy(ct)).sum(),
                                 [xt, m.A_log])
    assert all(bool(torch.isfinite(g).all()) for g in g_chunk)
    for a, b in zip(g_chunk, g_loop):
        _close(a, b.numpy(), 2e-5)


def test_mamba2_init_matches_reference_constants():
    _, tcfg = _cfgs("zamba2-2.7b")
    m = tssm.Mamba2(tcfg)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.requires_grad_(False)
    assert float(m.dt_bias.abs().max()) == 0.0 and float(m.A_log.abs().max()) == 0.0
    assert torch.equal(m.D_skip, torch.ones(tcfg.ssm_heads)) and float(m.norm.abs().max()) == 0.0
    assert abs(float(m.conv_w.std()) - 0.2) < 0.02
    assert abs(float(m.wo.std()) - tcfg.d_inner ** -0.5) < 0.1 * tcfg.d_inner ** -0.5
    assert m.dt_bias.dtype == torch.float32 and m.conv_w.dtype == torch.float32


# -- rwkv6 --------------------------------------------------------------------

@pytest.mark.parametrize("s", [37, 200, 16, 5])
@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_rwkv6_time_mix_matches_reference(rwkv, s, carry):
    jcfg, p, m = rwkv
    x = _x(2, s, jcfg.d_model, s)
    state = last = None
    if carry:
        rng = np.random.default_rng(s + 1)
        state = rng.standard_normal((2, jcfg.n_heads, jcfg.head_dim,
                                     jcfg.head_dim)).astype(np.float32)
        last = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jt = lambda a: None if a is None else jnp.asarray(a)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    y_j, st_j, l_j = jrwkv.rwkv6_time_mix(p, jnp.asarray(x), jcfg, jt(state), jt(last))
    with torch.no_grad():
        y_t, st_t, l_t = trwkv.rwkv6_time_mix(m, torch.from_numpy(x), tt(state), tt(last))
    _close(y_t, y_j)
    _close(st_t, st_j)
    assert np.array_equal(l_t.numpy(), np.asarray(l_j))


def test_rwkv6_time_mix_decode_matches_reference(rwkv):
    jcfg, p, m = rwkv
    rng = np.random.default_rng(20)
    x = _x(3, 1, jcfg.d_model, 21)
    state = rng.standard_normal((3, jcfg.n_heads, jcfg.head_dim, jcfg.head_dim)).astype(np.float32)
    last = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    y_j, st_j, _ = jrwkv.rwkv6_time_mix_decode(p, jnp.asarray(x), jcfg, jnp.asarray(state),
                                               jnp.asarray(last))
    with torch.no_grad():
        y_t, st_t, l_t = trwkv.rwkv6_time_mix_decode(m, torch.from_numpy(x),
                                                     torch.from_numpy(state),
                                                     torch.from_numpy(last))
    _close(y_t, y_j)
    _close(st_t, st_j)
    assert torch.equal(l_t, torch.from_numpy(x))


@pytest.mark.parametrize("with_last", [False, True])
def test_rwkv6_channel_mix_matches_reference(rwkv, with_last):
    jcfg, p, m = rwkv
    x = _x(2, 9, jcfg.d_model, 22)
    last = _x(2, 1, jcfg.d_model, 23) if with_last else None
    y_j, l_j = jrwkv.rwkv6_channel_mix(p, jnp.asarray(x), jcfg,
                                       None if last is None else jnp.asarray(last))
    with torch.no_grad():
        y_t, l_t = trwkv.rwkv6_channel_mix(m, torch.from_numpy(x),
                                           None if last is None else torch.from_numpy(last))
    _close(y_t, y_j)
    assert np.array_equal(l_t.numpy(), np.asarray(l_j))


@pytest.mark.parametrize("s", [37, 5])
def test_rwkv6_chunked_equals_token_loop(rwkv, s):
    """The chunked time mix against ``rwkv6_time_mix_decode`` token by token
    from a zero state: every output and the final WKV state."""
    jcfg, _, m = rwkv
    x = torch.from_numpy(_x(2, s, jcfg.d_model, 30))
    with torch.no_grad():
        y, st, last = trwkv.rwkv6_time_mix(m, x)
        state = torch.zeros(2, jcfg.n_heads, jcfg.head_dim, jcfg.head_dim)
        tok = torch.zeros(2, 1, jcfg.d_model)
        steps = []
        for t in range(s):
            yt, state, tok = trwkv.rwkv6_time_mix_decode(m, x[:, t:t + 1], state, tok)
            steps.append(yt)
    _close(y, torch.cat(steps, 1))
    _close(st, state)
    assert torch.equal(last, tok)


def test_rwkv6_gradients_match_reference(rwkv):
    """S = 37 (three chunks and a ragged tail): the gradients of x and of
    every leaf of the time mix."""
    jcfg, p, m = rwkv
    x = _x(2, 37, jcfg.d_model, 31)
    ct = _x(2, 37, jcfg.d_model, 32)
    fj = lambda p, x: jnp.sum(jrwkv.rwkv6_time_mix(p, x, jcfg)[0] * ct)
    gp, gx = jax.grad(fj, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x))
    names = ["mu", "wr", "wk", "wv", "wg", "w_base", "w_lora_a", "w_lora_b", "u_bonus", "ln_out",
             "wo"]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = trwkv.rwkv6_time_mix(m, xt)[0]
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), [xt] + [getattr(m, k)
                                                                        for k in names])
    _close(got[0], gx)
    for name, g in zip(names, got[1:]):
        _close(g, gp[name])


def test_rwkv6_init_matches_reference_constants():
    _, tcfg = _cfgs("rwkv6-3b")
    m = trwkv.RWKV6(tcfg)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.requires_grad_(False)
    hk = tcfg.n_heads * tcfg.head_dim
    assert torch.equal(m.mu, torch.full((5, tcfg.d_model), 0.5))
    assert torch.equal(m.mu_cm, torch.full((2, tcfg.d_model), 0.5))
    assert torch.equal(m.w_base, torch.full((hk,), -0.6))
    assert float(m.u_bonus.abs().max()) == 0.0 and float(m.ln_out.abs().max()) == 0.0
    assert abs(float(m.w_lora_b.std()) - 0.01) < 0.002
    assert abs(float(m.w_cm_2.std()) - tcfg.d_ff ** -0.5) < 0.1 * tcfg.d_ff ** -0.5
