"""GPT-2 weights drawn from a run's seed, on the run's device, in the
layout the port's engine takes (its parameter names, per-layer tensors
stacked on a leading L axis, weights (OC, IC), f32).

GPT-2's initialisation (``initializer_range`` 0.02): every matrix
N(0, 0.02), layernorm weights 1, biases 0. All the matrices come from
ONE draw of a ``torch.Generator`` on the device, carved into views, so
the same seed gives the same weights to the program and, after the
window, to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

MATRICES = ("wte", "wpe", "qkvw", "attprojw", "fcw", "fcprojw")


def shapes(L: int, C: int, V: int, T: int) -> Dict[str, tuple]:
    """Every parameter's shape (GPT-2's, with per-layer tensors stacked)."""
    return {"wte": (V, C), "wpe": (T, C),
            "ln1w": (L, C), "ln1b": (L, C),
            "qkvw": (L, 3 * C, C), "qkvb": (L, 3 * C),
            "attprojw": (L, C, C), "attprojb": (L, C),
            "ln2w": (L, C), "ln2b": (L, C),
            "fcw": (L, 4 * C, C), "fcb": (L, 4 * C),
            "fcprojw": (L, C, 4 * C), "fcprojb": (L, C),
            "lnfw": (C,), "lnfb": (C,)}


def seed64(seed: int) -> int:
    """A run's seed as the non-negative 64-bit integer both generators
    (torch's and numpy's) take."""
    return int(seed) % (1 << 64)


def make(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights of ``model`` (a config file's widths) from ``seed``."""
    device = torch.device(device)
    shp = shapes(model["n_layer"], model["n_embd"], model["vocab_size"],
                 model["n_positions"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    sizes = [math.prod(shp[k]) for k in MATRICES]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(model["initializer_range"])
    params = {}
    for k, part in zip(MATRICES, flat.split(sizes)):
        params[k] = part.view(shp[k])
    for k, s in shp.items():
        if k not in params:
            fill = 1.0 if k in ("ln1w", "ln2w", "lnfw") else 0.0
            params[k] = torch.full(s, fill, device=device)
    return params
