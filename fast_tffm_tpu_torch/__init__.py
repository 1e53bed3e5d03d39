"""fast_tffm_tpu_torch: the PyTorch/CUDA port of ``fast_tffm_tpu``.

The port mirrors the JAX package's module names so each file has an obvious
counterpart (``fast_tffm_tpu_torch/ops/fm.py`` ↔ ``fast_tffm_tpu/ops/fm.py``),
but it imports nothing from ``fast_tffm_tpu`` and never imports ``jax``: the
host-only modules it needs (config parsing, libsvm parsing, hashing) are its
own copies.

What this package covers so far: training an FM of any order on the rows
layout or the fused lane-packed layout (``training.py``), offline
prediction, and serving through the micro-batched ``ServingEngine``
(``serving/engine.py``), with the order ≥ 3 interaction DP, its backward
and both sparse Adagrad tails in hand-written CUDA kernels (``csrc/``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back to the CPU.

Submodules are imported explicitly (``from fast_tffm_tpu_torch.serving
import ServingEngine``); importing the package itself loads nothing else.
"""

__version__ = "0.1.0"
