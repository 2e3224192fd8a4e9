"""Readings behind the f32 and bf16 tolerances of the zamba2 / rwkv6 CPU tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_ssm_floor.py

Not a test (pytest does not collect it); it prints, on the CPU:

1. the whole-model gradient's spread in f32 (reduced zamba2, S = 64, the
   settings of tests/test_torch_training.py): each package against itself
   with the SSD chunk at 32 and 16 instead of 128, and port against
   reference; then each package's gradient at S = 256 against an f64
   evaluation of the same loss (the port's code run in float64), beside the
   reference's token-by-token form (tests/test_torch_recurrent.py:
   ``_tokenwise_reference_loss``);
2. the train step's drift over 3 steps (lr 3e-3): the reference against
   itself at another chunk size, and the port against the reference;
3. bf16 against f32 prefill logits at reduced width (d = 256) and 6, 18 and
   54 zamba2 layers, 32 rwkv6 layers, in both packages;
4. one mamba2 layer's gradient at S = 256 between SSD chunks of 128 and
   32, with the decays from ``_segsum`` and from a difference of
   cumulative sums (the reference's form);
5. the bf16 serving readings of tests/test_torch_lm.py's
   ``test_bf16_recurrent_families_match_reference`` (reduced(), seeds 3 and
   4): each leaf's distance between the packages' bf16 results and from
   the reference's f32 result, and the ratio that test holds.
Takes ~3 minutes.
"""
import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))

import test_torch_recurrent as R  # noqa: E402
import test_torch_training as T  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.training.serve import make_prefill_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import prefill_step  # noqa: E402


def scaled(a, b):
    """Largest |a - b| over the largest |b|, the worst leaf."""
    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max()
                     / np.abs(np.asarray(y, np.float64)).max()) for x, y in zip(a, b))


def ref_grads(cfg, tcfg, params, tok, lab, loss=None):
    loss = loss or (lambda p: T.jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab), cfg))
    g = jax.jit(jax.grad(loss))(params)
    return [x.numpy() for x in T._ref_grads(tcfg, g)]


def port_grads(model, tok, lab):
    loss = T.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab))
    return [g.detach().numpy() for g in torch.autograd.grad(loss, list(model.parameters()))]


def f64_grads(model, tok, lab):
    """The port's code in float64: ``Tensor.float`` leaves f64 alone."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self if self.dtype == torch.float64 else orig(self)
    try:
        return port_grads(copy.deepcopy(model).double(), tok, lab)
    finally:
        torch.Tensor.float = orig


def gradient_floor():
    jcfg, tcfg = T._family_cfgs("zamba2-2.7b")
    params = T.jinit_params(jax.random.key(0), jcfg)
    tok, lab = T._batch(jcfg.vocab, b=4)
    model = T.convert.lm_params_from_reference(T._np32(params), tcfg)
    r128, p128 = ref_grads(jcfg, tcfg, params, tok, lab), port_grads(model, tok, lab)
    for chunk in (32, 16):
        jssm._CHUNK = tssm._CHUNK = chunk
        print(f"S=64 chunk {chunk} vs 128: reference {scaled(ref_grads(jcfg, tcfg, params, tok, lab), r128):.2e}, "
              f"port {scaled(port_grads(model, tok, lab), p128):.2e}")
    jssm._CHUNK = tssm._CHUNK = 128
    print(f"S=64 port vs reference {scaled(p128, r128):.2e}")
    tok, lab = T._batch(jcfg.vocab, b=2, s=256, seed=4)
    truth = f64_grads(model, tok, lab)
    tokenwise = ref_grads(jcfg, tcfg, params, tok, lab, lambda p: R._tokenwise_reference_loss(
        p, jnp.asarray(tok), jnp.asarray(lab), jcfg))
    port = port_grads(model, tok, lab)
    print(f"S=256 against f64: port {scaled(port, truth):.2e}, reference token by token "
          f"{scaled(tokenwise, truth):.2e}; port vs token by token {scaled(port, tokenwise):.2e}")
    pure = dataclasses.replace(jcfg, attn_every=0)
    tpure = dataclasses.replace(tcfg, attn_every=0)
    ppure = T.jinit_params(jax.random.key(0), pure)
    mpure = T.convert.lm_params_from_reference(T._np32(ppure), tpure)
    jssm._CHUNK = 32
    print(f"S=256 without the shared block, against f64: port {scaled(port_grads(mpure, tok, lab), f64_grads(mpure, tok, lab)):.2e}, "
          f"reference at chunk 32 {scaled(ref_grads(pure, tpure, ppure, tok, lab), f64_grads(mpure, tok, lab)):.2e}")
    jssm._CHUNK = 128


def step_drift():
    for arch, mod, other in (("zamba2-2.7b", jssm, 32), ("rwkv6-3b", jrwkv, 8)):
        jcfg, tcfg = T._family_cfgs(arch)
        init = T.jtrain_state_init(T.jinit_params(jax.random.key(1), jcfg))

        def ref_run():
            st, out = init, []
            step = jax.jit(T.jmake_train_step(jcfg, lr=3e-3))
            for i in range(3):
                tok, lab = T._batch(jcfg.vocab, seed=10 + i)
                st, m = step(st, jnp.asarray(tok), jnp.asarray(lab))
                out.append((float(m["loss"]), float(m["grad_norm"])))
            return out

        a = ref_run()
        default = mod._CHUNK
        mod._CHUNK = other
        b = ref_run()
        mod._CHUNK = default
        tst = T.convert.train_state_from_reference(T._ref_state_numpy(init), tcfg)
        tstep = T.make_train_step(tcfg, lr=3e-3)
        c = []
        for i in range(3):
            tok, lab = T._batch(jcfg.vocab, seed=10 + i)
            tst, m = tstep(tst, tok, lab)
            c.append((float(m["loss"]), float(m["grad_norm"])))
        rel = lambda x, y: [f"{abs(p - q) / q:.1e}" for p, q in zip(x, y)]
        for i in range(3):
            print(f"{arch} step {i + 1} (loss, grad norm): reference chunk {other} vs default "
                  f"{rel(b[i], a[i])}; port vs reference {rel(c[i], a[i])}")


def depth_growth():
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for arch, layers in (("zamba2-2.7b", 6), ("zamba2-2.7b", 18), ("zamba2-2.7b", 54),
                         ("rwkv6-3b", 32)):
        kw = dict(n_layers=layers, vocab=512, d_model=256)
        if arch.startswith("zamba2"):
            kw["attn_every"] = 6
        jcfg, tcfg = jconfigs.get_config(arch).reduced(**kw), tconfigs.get_config(arch).reduced(**kw)
        params = T.jinit_params(jax.random.key(0), jcfg)
        p = np.random.default_rng(0).integers(0, 512, (2, 200)).astype(np.int32)
        run = lambda cfg, prm: np.asarray(jax.jit(make_prefill_step(cfg, 200))(prm, jnp.asarray(p))[0])
        rb, rf = run(jcfg, params), run(dataclasses.replace(jcfg, dtype="float32"), T._np32(params))
        outs = []
        for dt in ("bfloat16", "float32"):
            m = T.convert.lm_params_from_reference(T._np32(params), dataclasses.replace(tcfg, dtype=dt))
            with torch.inference_mode():
                outs.append(prefill_step(m, torch.from_numpy(p), 200)[0].numpy())
        print(f"{arch} {layers} layers, bf16 vs f32 logits: reference {rel(rb, rf):.2e}, port "
              f"{rel(outs[0], outs[1]):.2e}")


def segsum_vs_difference():
    jcfg, tcfg = jconfigs.get_config("zamba2-2.7b").reduced(dtype="float32"), \
        tconfigs.get_config("zamba2-2.7b").reduced(dtype="float32")
    p = jssm.mamba2_init(jax.random.key(1), jcfg, jnp.float32)
    m = tssm.Mamba2(tcfg)
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(torch.from_numpy(np.array(v)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, jcfg.d_model)).astype(np.float32)
    ct = torch.from_numpy(rng.standard_normal((2, 256, jcfg.d_model)).astype(np.float32))

    def grads():
        xt = torch.from_numpy(x).requires_grad_(True)
        y = tssm.mamba2_forward(m, xt)[0]
        return [g.numpy() for g in torch.autograd.grad((y * ct).sum(), [xt, *m.parameters()])]

    def difference(loga):
        q = loga.shape[-1]
        c = torch.cumsum(loga, dim=-1)
        return (c[..., :, None] - c[..., None, :]).masked_fill(
            ~torch.ones(q, q, dtype=torch.bool).tril(), float("-inf"))

    segsum = tssm._segsum
    for name, fn in (("segment sums", segsum), ("a difference of cumulative sums", difference)):
        tssm._segsum = fn
        tssm._CHUNK = 128
        a = grads()
        tssm._CHUNK = 32
        b = grads()
        print(f"one layer's gradient, chunk 128 vs 32, decays from {name}: {scaled(a, b):.2e}")
    tssm._segsum, tssm._CHUNK = segsum, 128


def bf16_serving():
    import test_torch_lm as L

    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for arch in L.RECURRENT:
        for seed in (3, 4):
            jcfg, tcfg = L._reduced(arch, dtype="bfloat16")
            params = L.jinit_params(jax.random.key(seed), jcfg)
            prompt = L._prompt(jcfg.vocab, seed=seed)

            def ref(cfg, p):
                logits, cache = jax.jit(L.make_prefill_step(cfg, L.S + 4))(p, jnp.asarray(prompt))
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
                _, logits2, _ = jax.jit(L.make_decode_step(cfg))(p, tok, cache)
                return dict(prefill=logits, decode=logits2, tok=tok,
                            **{k: v for k, v in cache.items() if k != "pos"})

            want = ref(jcfg, params)
            f32 = ref(dataclasses.replace(jcfg, dtype="float32"), L._np32(params))
            model = L.convert.lm_params_from_reference(L._np32(params), tcfg)
            with torch.no_grad():
                got, tcache = L.prefill_step(model, torch.from_numpy(prompt), L.S + 4)
                got = dict(prefill=got, **{k: v.clone() for k, v in tcache.items() if k != "pos"})
                got["decode"], _ = L.serve_step(model, torch.from_numpy(np.array(want["tok"])),
                                                tcache)
            for key, leaf in got.items():
                a, b, c = (np.asarray(x, np.float32) for x in (leaf.float(), want[key], f32[key]))
                print(f"{arch} seed {seed} {key}: port vs reference {rel(a, b):.2e}; from f32: port "
                      f"{rel(a, c):.2e}, reference {rel(b, c):.2e}, ratio {rel(a, c) / rel(b, c):.2f}")


if __name__ == "__main__":
    gradient_floor()
    step_drift()
    depth_growth()
    segsum_vs_difference()
    bf16_serving()
