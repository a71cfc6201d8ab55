"""Weights drawn from a run's seed, on the run's device: what every
family's ``make_weights`` shares. All of a model's random matrices come
from ONE draw of a ``torch.Generator`` on the device, carved into views,
so the same seed gives the same weights to the program and, after the
window, to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def seed64(seed: int) -> int:
    """A run's seed as the non-negative 64-bit integer both generators
    (torch's and numpy's) take."""
    return int(seed) % (1 << 64)


def normal(shapes: Dict[str, tuple], seed: int, device,
           std: float) -> Dict[str, torch.Tensor]:
    """f32 tensors of ``shapes`` (in their order), N(0, ``std``), from one
    draw seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(std)
    return {k: part.view(s) for (k, s), part in
            zip(shapes.items(), flat.split(sizes))}
