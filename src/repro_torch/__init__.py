"""PyTorch/CUDA port of the Scaled Block Vecchia GP package (``repro``).

Mirrors ``repro``'s module layout; imports torch, numpy and scipy, never
jax and nothing of ``repro``. Entry points (``core.fit.fit_sbv``,
``core.predict.predict_sbv``) run on the current CUDA device unless the
caller passes ``device='cpu'``. The hot loops are hand-written CUDA
kernels under ``csrc/``, built on first use (``kernels/_build.py``).
"""
