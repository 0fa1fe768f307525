"""Hand-written Hopper kernels (CUDA C++ under ``kvquant_tpu_torch/csrc``),
each beside its plain PyTorch version and a wrapper that counts launches.

The counts mean kernel launches on the card. A CUDA graph
(``engine.DecodeGraph``) launches nothing while it captures and launches
every captured kernel at each replay, so it records the counters' increase
over its capture (``counted``), sets them back, and adds that increase at
each replay (``add_launches``)."""


def _counters() -> dict:
    """Every launch counter by name: (object, attribute)."""
    from . import (attention, flash_decode, flash_serial, moe_experts,
                   paged_decode)

    return {"K1": (flash_decode.flash_attention, "launches"),
            "K1_chunk": (flash_decode.flash_attention, "chunk_launches"),
            "K1_gqa": (flash_decode.flash_attention, "gqa_launches"),
            "K2": (flash_serial.flash_serial_decode, "launches"),
            "K3": (attention.qk_fused, "launches"),
            "K3_gqa": (attention.qk_fused, "gqa_launches"),
            "K4": (attention.pv_fused, "launches"),
            "K5": (paged_decode.paged_flash_decode, "launches"),
            "K5_gqa": (paged_decode.paged_flash_decode, "gqa_launches"),
            "moe_experts": (moe_experts.moe_experts, "launches")}


def launch_counts() -> dict:
    """Launches so far of each kernel wrapper on a card, by the TPU
    kernel it ports: K1 flash_attention, K2 flash_serial_decode, K3
    qk_fused, K4 pv_fused, K5 paged_flash_decode; and "moe_experts", the
    MoE family's expert products, which port no TPU kernel."""
    return {k: getattr(o, a) for k, (o, a) in _counters().items()
            if "_" not in k or k == "moe_experts"}


def snapshot() -> dict:
    """Every counter: those of ``launch_counts``, K1's chunk launches
    ("K1_chunk"), the launches on the tensor-core decode bodies of K1, K3
    and K5 ("K1_gqa", "K3_gqa", "K5_gqa") and K2's launches per body
    ("K2:<body>")."""
    from .flash_serial import flash_serial_decode

    out = {k: getattr(o, a) for k, (o, a) in _counters().items()}
    for body, n in flash_serial_decode.route_launches.items():
        out[f"K2:{body}"] = n
    return out


def _set(name: str, value: int):
    from .flash_serial import flash_serial_decode

    if name.startswith("K2:"):
        flash_serial_decode.route_launches[name[3:]] = value
    else:
        obj, attr = _counters()[name]
        setattr(obj, attr, value)


def add_launches(delta: dict):
    """Add ``delta`` (name -> launches, as ``snapshot`` names them) to the
    counters."""
    now = snapshot()
    for name, n in delta.items():
        if n:
            _set(name, now.get(name, 0) + n)


def counted(fn):
    """Run ``fn()``; returns (its result, the counters' increase over it)
    and sets the counters back to where they were."""
    before = snapshot()
    try:
        out = fn()
    finally:
        after = snapshot()
        for name in after:
            _set(name, before.get(name, 0))
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
