"""Weight carry-over from the JAX package.

``params_from_numpy`` takes GPT-2 parameters as the JAX package holds
them, given as numpy arrays — the stacked (L, ...) dict that
``formats.read_checkpoint`` returns, or ``np.asarray`` of each leaf of a
device params pytree — and returns the port's params. wte may come
padded to the JAX package's ``padded_vocab_size`` (its padded rows are
zero and never sampled) or unpadded; the port keeps V rows. The KV pool
needs no converter: both packages use the (P, NH, HS, ps) page layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from llmc_paged_tpu_torch.config import GPT2Config
from llmc_paged_tpu_torch.models import gpt2


def params_from_numpy(params_np: Dict[str, np.ndarray], cfg: GPT2Config,
                      device=None, dtype=torch.float32):
    """JAX-package float params (numpy) → the port's params on ``device``
    (the card by default) in ``dtype``, layernorms fp32. Raises on a
    missing, extra or misshapen leaf."""
    shapes = gpt2.param_shapes(cfg)
    if set(params_np) != set(shapes):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(shapes) - set(params_np))}, extra "
                         f"{sorted(set(params_np) - set(shapes))}")
    for name, shape in shapes.items():
        got = tuple(np.shape(params_np[name]))
        ok = got == shape or (name == "wte" and got[1:] == shape[1:]
                              and got[0] >= shape[0])
        if not ok:
            raise ValueError(f"{name}: shape {got}, expected {shape}")
    return gpt2.to_device(params_np, cfg, dtype=dtype, device=device)
