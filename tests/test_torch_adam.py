"""Port vs reference: Adam with float32 moments on float64 params."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import adam_init as ref_init  # noqa: E402
from repro.optim import adam_update as ref_update  # noqa: E402
from repro_torch.optim import adam_init, adam_update  # noqa: E402


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_ten_steps_match_reference(weight_decay):
    rng = np.random.default_rng(0)
    p0 = (rng.normal(size=()), rng.normal(size=(4,)), rng.normal(size=()))
    grads = [tuple(rng.normal(size=np.shape(a)) * 10.0 ** rng.integers(-3, 2) for a in p0)
             for _ in range(10)]
    rp = tuple(jnp.asarray(a, jnp.float64) for a in p0)
    rs = ref_init(rp)
    tp = tuple(torch.tensor(a, dtype=torch.float64) for a in p0)
    ts = adam_init(tp)
    for g in grads:
        rp, rs = ref_update(tuple(jnp.asarray(a) for a in g), rs, rp, 0.05,
                            weight_decay=weight_decay)
        tp, ts = adam_update(tuple(torch.tensor(a) for a in g), ts, tp, 0.05,
                             weight_decay=weight_decay)
    for a, b in zip(tp, rp):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(ts.mu + ts.nu, rs.mu + rs.nu):
        assert a.dtype == torch.float32 and np.asarray(b).dtype == np.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert ts.step == int(rs.step) == 10


def test_namedtuple_params_keep_their_type():
    from repro_torch.core.kernels_math import KernelParams

    p = KernelParams.create(sigma2=1.0, beta=[0.5, 2.0], nugget=1e-3)
    new, _ = adam_update(tuple(torch.ones_like(a) for a in p), adam_init(p), p, 0.1)
    assert isinstance(new, KernelParams)
    np.testing.assert_allclose(new.log_beta.numpy(), p.log_beta.numpy() - 0.1, atol=1e-5)
