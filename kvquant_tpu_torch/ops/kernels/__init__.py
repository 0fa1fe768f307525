"""Hand-written Hopper kernels (CUDA C++ under ``kvquant_tpu_torch/csrc``),
each beside its plain PyTorch version and a wrapper that counts launches."""
