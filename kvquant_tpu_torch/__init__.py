"""kvquant_tpu_torch — the PyTorch/CUDA port of kvquant_tpu for NVIDIA Hopper.

The JAX package ``kvquant_tpu`` is the reference; this package mirrors its
module names (``cache``, ``engine``, ``models.llama``, ``ops.deployed``, ...)
so each function can be found beside its counterpart. Plain tensor code is
PyTorch; each Pallas TPU kernel on the ported path is a hand-written CUDA
kernel under ``csrc/`` (see ``ops/kernels``).

Nothing here imports JAX or the JAX package. Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise when no card is present;
tests pass ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"
