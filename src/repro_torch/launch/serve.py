"""Batched serving from the command line, LM mode: prefill + greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --reduced --batch 2 --prompt-len 32 --max-new 8 --device cpu

The counterpart of ``repro.launch.serve``'s LM mode, with its defaults and
prints. Weights are drawn from ``torch.Generator`` seed 0 on the device; the
prompt from ``np.random.default_rng(3)``, as there. Runs on the current CUDA
device unless ``--device`` names another; without a CUDA device and without
``--device`` it raises. The port is single-device, so ``--mesh`` takes only
``1x1``. The GP mode (``serve gp``) is not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, prefill_step, serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "gp":
        raise NotImplementedError("serve gp: the GP serving mode is not ported yet "
                                  "(ROADMAP queue 1 item 12)")

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: the port is single-device, only 1x1 runs "
                 "(multi-device is ROADMAP queue 1 item 8)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cache_len = args.prompt_len + args.max_new

    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)

    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)), dtype=torch.int32
    ).to(device)

    with torch.inference_mode():
        _sync(device)
        t0 = time.time()
        logits, cache = prefill_step(model, prompt, cache_len)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        _sync(device)
        print(f"[serve] prefill {args.batch}x{args.prompt_len}: {time.time()-t0:.2f}s")

        out = [tok]
        t0 = time.time()
        for _ in range(args.max_new - 1):
            logits, cache = serve_step(model, tok, cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(tok)
        toks = torch.cat(out, dim=1)
        _sync(device)
        dt = time.time() - t0
    rate = args.batch * (args.max_new - 1) / dt
    print(f"[serve] decoded {args.max_new-1} steps x {args.batch} seqs: "
          f"{dt:.2f}s ({rate:.1f} tok/s)")
    print("[serve] sample tokens:", toks[0, :16].cpu().numpy())
    return toks


if __name__ == "__main__":
    main()
