"""crypto_tpu_torch: the PyTorch/CUDA port of crypto_tpu for NVIDIA Hopper.

The JAX package `crypto_tpu` is the reference; this package imports
nothing of it and never imports `jax`.  Device field elements are int32
tensors holding uint32 bit patterns, limb-major: an Fq batch is a
`(12, ...)` tensor (32-bit limbs, least significant first, Montgomery
form with R = 2^384), an Fr batch `(8, ...)` (R = 2^256).  The limb-major
layout is the kernels' own, so thread i reads limb j at `j*M + i`.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller names the
    CPU; raises when CUDA is asked for and there is no card, so nothing
    carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "crypto_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain versions")
    return dev
