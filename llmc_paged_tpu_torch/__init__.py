"""llmc_paged_tpu_torch — the paged GPT-2 inference engine in PyTorch and
CUDA for NVIDIA Hopper (sm_90a).

A port of the JAX package ``llmc_paged_tpu``, which stays the reference.
This package imports torch and numpy only: never jax, and no module of
the JAX package. The CUDA kernels build from ``csrc/`` at first use on
the card, never at import, so the package imports on a machine without
a GPU, nvcc or triton.
"""

from __future__ import annotations

import os

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. ``None`` means "cuda", and raises when no GPU is present
    (there is no silent fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def platform_device():
    """The device LLMC_PLATFORM asks for, as the entry points' CLIs read
    it: unset → the card (None), "cpu" → the CPU; any other value
    raises."""
    plat = os.environ.get("LLMC_PLATFORM")
    if not plat:
        return None
    if plat != "cpu":
        raise ValueError(f"LLMC_PLATFORM={plat!r}: the torch port takes "
                         "'cpu' (unset: the card)")
    return "cpu"

