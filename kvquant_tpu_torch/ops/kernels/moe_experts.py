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
widths that are multiples of 16 bytes, on one of two bodies (``body``):

  - ``"mma"`` (bf16 at the rows of ``MMA_ROWS``, D and F multiples of
    ``MMA_STAGE_ROWS``, at most ``MMA_MAX_EXPERTS`` experts): tensor
    cores, the weights through a ring of bulk copies, persistent blocks
    sharing the work evenly. It reads the rows as they are, (E, C, D),
    and needs the scratch ``moe_experts_scratch`` sizes: fp32 partials
    and a ticket array that the kernels leave zero, made zero once per
    device here (``_tickets``) and kept;
  - ``"simt"`` (fp32, and the rest): the instance of ``kernel_rows(C)``
    rows, reading the rows by element, (E, D, CR), which the wrapper lays
    out (a view at C 1).

Both round where the plain version rounds (gate and up, silu(gate),
silu * up, the down product, each to the dtype). ``moe_experts.launches``
counts the calls that launched it (one per call: its two kernels),
``moe_experts.launches_by_body`` the same per body. ``moe_ablation.py``
times the bodies and their shapes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .common import check_operands

KERNEL_ROWS = 8  # csrc MAX_ROWS: capacity rows an expert the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc DT_*
BODIES = {"simt": 0, "mma": 1}  # csrc BODY_*
# rows an expert at which bf16 calls take the tensor-core body: where
# moe_ablation.py timed it faster than the SIMT body at one DBRX layer on an
# H100 (C 2 / 4 / 8: 3-4%, 5-9%, 24-26%; C 3, 5-7 run the SIMT instances
# of C 4 and 8). At C 1 the two tie within 1% from call to call, and the
# SIMT body reads the rows there as a view, so C 1 stays on it.
MMA_ROWS = (2, 3, 4, 5, 6, 7, 8)
MMA_STAGE_ROWS = 32  # csrc MT_BK: D and F are multiples of it
MMA_MAX_EXPERTS = 256  # csrc MT_MAX_E


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
    lib.moe_experts.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                I, P]
    lib.moe_experts.restype = I
    lib.moe_experts_scratch.argtypes = [I, I, I, P]
    lib.moe_experts_scratch.restype = I
    return lib


def load_library():
    """Build (on first use) and load the kernel library."""
    return _lib()


def kernel_rows(C: int) -> int:
    """The capacity rows of the SIMT instance that runs C rows an expert
    (csrc compiled_rows): the least of 1 / 2 / 4 / 8 that holds them."""
    if not 1 <= C <= KERNEL_ROWS:
        raise ValueError(f"moe_experts: {C} rows an expert, kernel takes "
                         f"1..{KERNEL_ROWS}")
    return next(r for r in (1, 2, 4, 8) if r >= C)


def mma_takes(dtype, E: int, D: int, Fd: int) -> bool:
    """Whether the tensor-core body can run E experts at widths D, Fd:
    bf16 (fp32 operands would run as TF32, below the dtype's precision),
    widths that fill whole ring stages, a live list that holds E."""
    return (dtype == torch.bfloat16 and E <= MMA_MAX_EXPERTS
            and D % MMA_STAGE_ROWS == 0 and Fd % MMA_STAGE_ROWS == 0)


def body(C: int, dtype, E: int, D: int, Fd: int) -> str:
    """The body that runs C rows an expert of E experts at widths D, Fd:
    "mma" where ``mma_takes`` and C is in ``MMA_ROWS``, else "simt"."""
    kernel_rows(C)
    return "mma" if C in MMA_ROWS and mma_takes(dtype, E, D, Fd) else "simt"


def kernel_rows_operand(xe, route: str):
    """The rows as the body reads them: ``xe`` itself (E, C, D) for
    "mma"; by element, (E, D, CR) zero past C, for "simt" (a view of xe
    at C 1, else a copy)."""
    if route == "mma":
        return xe
    C = xe.shape[1]
    x = xe.transpose(1, 2)
    if C != kernel_rows(C):
        x = F.pad(x, (0, kernel_rows(C) - C))
    return x.contiguous()


@functools.lru_cache(maxsize=None)
def _scratch_sizes(lib, device: str, E: int, D: int, Fd: int) -> tuple:
    """(fp32 partials, int32 tickets) of the tensor-core body on
    ``device``, the current one."""
    out = (ctypes.c_longlong * 4)()
    err = lib.moe_experts_scratch(E, D, Fd, out)
    if err != 0:
        raise RuntimeError(f"moe_experts scratch query failed: cudaError "
                           f"{err}")
    return int(out[0]), int(out[1])


_tickets: dict = {}  # device -> int32 tickets, zero between calls


def tickets(device, n: int):
    """The device's ticket array, at least ``n`` long: made zero at the
    first call (and where a longer one is needed), then left zero by every
    call of the tensor-core body, which takes a ticket a shared tile and
    sets it back. Calls on one device run in stream order (one stream, or
    graphs replayed on it), so they never hold tickets at once."""
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = _tickets[device] = torch.zeros((n,), dtype=torch.int32,
                                           device=device)
    return t


def moe_experts(xe, count, w_gate, w_up, w_down, body_name=None):
    """The SwiGLU expert products of the live capacity slots: xe (E, C, D)
    the slots' rows, count (E,) int32 the live slots of each expert,
    w_gate / w_up (E, D, F), w_down (E, F, D). Returns y (E, C, D) in xe's
    dtype, row c of expert e its product for c < count[e], else 0.

    CPU tensors take ``moe_experts_plain``. On a card the kernel on the
    body of ``body`` (``body_name`` forces one, for timing), which raises
    ValueError for what it does not take (C > ``KERNEL_ROWS``, a dtype
    other than bf16 / fp32, widths not a multiple of 16 bytes, operands
    that need a gradient: it has no backward, a forced "mma" the call
    cannot take) and RuntimeError when a launch fails."""
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
    route = body(C, dt, E, D, Fd)
    if body_name is not None:
        if body_name not in BODIES or (body_name == "mma" and not mma_takes(
                dt, E, D, Fd)):
            raise ValueError(f"moe_experts: body {body_name!r} cannot run "
                             f"this call")
        route = body_name
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
    for name, t in (("xe", xe), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_experts: {name} is not 16-byte aligned")
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream(xe.device).cuda_stream
        return _launch(_lib(), route, xe, count, w_gate, w_up, w_down,
                       stream)


def _launch(lib, route, xe, count, w_gate, w_up, w_down, stream):
    """Lay out the rows and the scratch of body ``route``, launch the
    kernel and count it; returns y."""
    E, C, D = xe.shape
    Fd = w_gate.shape[-1]
    dt, dev = xe.dtype, xe.device
    x = kernel_rows_operand(xe, route)
    if route == "mma":
        CR = C
        n_part, n_tick = _scratch_sizes(lib, str(dev), E, D, Fd)
        a = torch.empty((E, C, Fd), dtype=dt, device=dev)
        part = torch.empty((n_part,), dtype=torch.float32, device=dev)
        ptrs = (part.data_ptr(), tickets(dev, n_tick).data_ptr())
    else:
        CR = kernel_rows(C)
        a = torch.empty((E, Fd, CR), dtype=dt, device=dev)
        ptrs = (None, None)
    y = torch.empty((E, C, D), dtype=dt, device=dev)
    err = lib.moe_experts(
        x.data_ptr(), count.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), a.data_ptr(), y.data_ptr(), *ptrs, E, C, CR, D,
        Fd, DTYPES[dt], BODIES[route], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"moe_experts kernel ({route}) launch failed: "
                           f"cudaError {err}")
    moe_experts.launches += 1
    moe_experts.launches_by_body[route] += 1
    return y


moe_experts.launches = 0
moe_experts.launches_by_body = {b: 0 for b in BODIES}
