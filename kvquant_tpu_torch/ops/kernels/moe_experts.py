"""The SwiGLU expert products of the MoE family's capacity dispatch at
decode sizes (``models.moe.moe_ffn_sparse``): ``csrc/moe_experts.cu``.

It replaces no TPU kernel: the JAX package's dispatch einsums
(kvquant_tpu/models/moe.py:113-152) leave these products to XLA, which at
decode (C = 1) reads every expert's weights. The kernel reads ``count``
on the card and skips an expert with no live slot, so it reads only the
routed experts' weights, with no host read (a CUDA graph captures it).

  - ``moe_experts_plain``: the products over (E, C, ·) with ``torch.bmm``
    in the weights' dtype, rows at or past ``count[e]`` zeroed. The CPU
    and the tests use it; nothing on a card does.
  - ``moe_experts``: the plain version for CPU tensors; on a card the
    kernel (``moe_glu`` then ``moe_down``, one call of the C entry
    ``moe_experts``), or an exception. There is no fallback.

The kernel takes C <= ``KERNEL_ROWS`` rows an expert, bf16 or fp32, and
widths that are multiples of 16 bytes; it runs the instance of
``kernel_rows(C)`` rows, reading the rows by element, (E, D, CR), which
the wrapper lays out (a view at C 1). It rounds where the plain version
rounds (gate and up, silu(gate), silu * up, the down product, each to the
dtype). ``moe_experts.launches`` counts the calls that launched it (one
per call: its two kernels). ``moe_ablation.py`` times its block shapes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .common import check_operands

KERNEL_ROWS = 8  # csrc MAX_ROWS: capacity rows an expert the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc DT_*


def swiglu_products(xe, w_gate, w_up, w_down):
    """The SwiGLU experts on the rows xe (E, C, D) with ``torch.bmm``
    over (E, C, ·), the JAX einsums' products: (E, C, D) in xe's dtype."""
    return torch.bmm(F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up),
                     w_down)


def moe_experts_plain(xe, count, w_gate, w_up, w_down):
    """Plain PyTorch version of the kernel: ``swiglu_products``, with the
    rows at or past ``count[e]`` (E,) of expert e set to 0."""
    y = swiglu_products(xe, w_gate, w_up, w_down)
    C = xe.shape[1]
    dead = torch.arange(C, device=xe.device)[None] >= count[:, None]
    return y.masked_fill(dead[..., None], 0)


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load

    lib = load("moe_experts")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.moe_experts.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.moe_experts.restype = I
    return lib


def load_library():
    """Build (on first use) and load the kernel library."""
    return _lib()


def kernel_rows(C: int) -> int:
    """The capacity rows of the kernel instance that runs C rows an expert
    (csrc compiled_rows): the least of 1 / 2 / 4 / 8 that holds them."""
    if not 1 <= C <= KERNEL_ROWS:
        raise ValueError(f"moe_experts: {C} rows an expert, kernel takes "
                         f"1..{KERNEL_ROWS}")
    return next(r for r in (1, 2, 4, 8) if r >= C)


def moe_experts(xe, count, w_gate, w_up, w_down):
    """The SwiGLU expert products of the live capacity slots: xe (E, C, D)
    the slots' rows, count (E,) int32 the live slots of each expert,
    w_gate / w_up (E, D, F), w_down (E, F, D). Returns y (E, C, D) in xe's
    dtype, row c of expert e its product for c < count[e], else 0.

    CPU tensors take ``moe_experts_plain``. On a card the kernel, which
    raises ValueError for what it does not take (C > ``KERNEL_ROWS``, a
    dtype other than bf16 / fp32, widths not a multiple of 16 bytes,
    operands that need a gradient: it has no backward) and RuntimeError
    when a launch fails."""
    if xe.device.type == "cpu":
        return moe_experts_plain(xe, count, w_gate, w_up, w_down)
    if xe.device.type != "cuda":
        raise ValueError(f"moe_experts: unsupported device {xe.device}")
    E, C, D = xe.shape
    Fd = w_gate.shape[-1]
    dt = xe.dtype
    if dt not in DTYPES:
        raise ValueError(f"moe_experts: dtype {dt}, kernel takes "
                         f"{list(DTYPES)}")
    CR = kernel_rows(C)
    vec = 16 // xe.element_size()
    if D % vec or Fd % vec:
        raise ValueError(f"moe_experts: widths D {D}, F {Fd} must be "
                         f"multiples of {vec}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xe, w_gate, w_up, w_down)):
        raise ValueError("moe_experts: the kernel has no backward")
    check_operands("moe_experts", {
        "xe": (xe, (E, C, D), dt), "count": (count, (E,), torch.int32),
        "w_gate": (w_gate, (E, D, Fd), dt), "w_up": (w_up, (E, D, Fd), dt),
        "w_down": (w_down, (E, Fd, D), dt)}, xe.device)
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_experts: {name} is not 16-byte aligned")
    # the kernel reads each input element's CR rows in one load: the rows
    # by element, (E, D, CR), zero past C (at C 1 a view of xe)
    x = xe.transpose(1, 2)
    if C != CR:
        x = F.pad(x, (0, CR - C))
    x = x.contiguous()
    a = torch.empty((E, Fd, CR), dtype=dt, device=xe.device)
    y = torch.empty((E, C, D), dtype=dt, device=xe.device)
    lib = _lib()
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream(xe.device).cuda_stream
        err = lib.moe_experts(
            x.data_ptr(), count.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), a.data_ptr(), y.data_ptr(),
            E, C, CR, D, Fd, DTYPES[dt], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"moe_experts kernel launch failed: cudaError "
                           f"{err}")
    moe_experts.launches += 1
    return y


moe_experts.launches = 0
