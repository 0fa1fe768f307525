"""Hand-written Hopper kernels (CUDA C++ under ``kvquant_tpu_torch/csrc``),
each beside its plain PyTorch version and a wrapper that counts launches."""


def launch_counts() -> dict:
    """Launches so far of each kernel wrapper on a card, by the TPU
    kernel it ports: K1 flash_attention, K2 flash_serial_decode, K3
    qk_fused, K4 pv_fused, K5 paged_flash_decode."""
    from . import attention, flash_decode, flash_serial, paged_decode

    return {"K1": flash_decode.flash_attention.launches,
            "K2": flash_serial.flash_serial_decode.launches,
            "K3": attention.qk_fused.launches,
            "K4": attention.pv_fused.launches,
            "K5": paged_decode.paged_flash_decode.launches}
