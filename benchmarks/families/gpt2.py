"""GPT-2 (``model_type`` "gpt2", and every config file that names none):
all that the harness knows of this family of models. A family module
provides

* ``program_config(cfg)`` and ``engine_config(cfg, concurrency)``: the
  program's model config and engine config for a config file (``cfg``)
  served at ``concurrency`` rows;
* ``make_weights(cfg, seed, device)``: f32 weights from a run's seed, on
  the device, in the layout the program takes;
* ``served_model(params32, cfg, precision)`` with ``REFERENCE`` and
  ``CONTROL``: the plain reference built from those weights at the
  configuration's precision or one step below it; its
  ``logits(prompt, generated, all_prompt_rows)`` is what ``check.py``
  reads;
* ``flops(cfg)``: ``prefill(n, lm_rows)`` and ``decode(ctx)``, the FLOPs
  one real token needs (``mfu.*``);
* ``kernels(cfg)``: {key: (kernel name regex, bound_s(span record),
  expected calls(span record))}, the kernels the per-layer readers take
  from the trace (``record["trace"][key]``);
* ``span_targets()``: [(module, attribute, kind, describe)], the
  program's device entries the harness wraps in traced runs, and what
  each call's record holds.

GPT-2's widths are ``n_layer``, ``n_embd``, ``n_head``, ``n_positions``
and ``vocab_size`` (openai-community/gpt2*'s config.json); the serving
mode is the config file's ``serving`` group.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch

from benchmarks import roofline, weights
from benchmarks.reference import gpt2_ref
from llmc_paged_tpu_torch.config import EngineConfig, GPT2Config, PageConfig
from llmc_paged_tpu_torch.models import gpt2_paged

REFERENCE, CONTROL = gpt2_ref.REFERENCE, gpt2_ref.CONTROL

# the single-query int8 parts kernel (query tile 1, not normalized) and
# the causal flash kernel of the prefill
KERNELS = {"parts": r"parts_kernel<[^,]+, signed char, true, \d+, 1, \d+, "
                    r"false",
           "flash": r"flash_fwd_kernel"}

# GPT-2's initialisation (``initializer_range``): every matrix N(0, r),
# layernorm weights 1, biases 0
MATRICES = ("wte", "wpe", "qkvw", "attprojw", "fcw", "fcprojw")
LN_WEIGHTS = ("ln1w", "ln2w", "lnfw")


def program_config(cfg: dict) -> GPT2Config:
    return GPT2Config(max_seq_len=cfg["n_positions"],
                      vocab_size=cfg["vocab_size"],
                      num_layers=cfg["n_layer"], num_heads=cfg["n_head"],
                      channels=cfg["n_embd"])


def engine_config(cfg: dict, concurrency: int) -> EngineConfig:
    s = cfg["serving"]
    page = PageConfig(page_size=s["page_size"],
                      num_pages=concurrency * s["pages_per_seq"]
                      + s["spare_pages"],
                      max_seqs=concurrency, pages_per_seq=s["pages_per_seq"],
                      kv_dtype=s["kv_dtype"])
    return EngineConfig(cache_mode="paged", page=page,
                        param_dtype=s["param_dtype"],
                        activation_dtype=s["activation_dtype"],
                        prefill_param_dtype=s["prefill_param_dtype"],
                        max_batch=concurrency, greedy=s["greedy"],
                        decode_chunk=s["decode_chunk"])


def shapes(L: int, C: int, V: int, T: int) -> Dict[str, tuple]:
    """Every parameter's shape (GPT-2's, with per-layer tensors stacked on
    a leading L axis, weights (OC, IC))."""
    return {"wte": (V, C), "wpe": (T, C),
            "ln1w": (L, C), "ln1b": (L, C),
            "qkvw": (L, 3 * C, C), "qkvb": (L, 3 * C),
            "attprojw": (L, C, C), "attprojb": (L, C),
            "ln2w": (L, C), "ln2b": (L, C),
            "fcw": (L, 4 * C, C), "fcb": (L, 4 * C),
            "fcprojw": (L, C, 4 * C), "fcprojb": (L, C),
            "lnfw": (C,), "lnfb": (C,)}


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights of ``cfg`` from ``seed``, under the port's parameter
    names."""
    device = torch.device(device)
    shp = shapes(cfg["n_layer"], cfg["n_embd"], cfg["vocab_size"],
                 cfg["n_positions"])
    params = weights.normal({k: shp[k] for k in MATRICES}, seed, device,
                            cfg["initializer_range"])
    for k, s in shp.items():
        if k not in params:
            fill = 1.0 if k in LN_WEIGHTS else 0.0
            params[k] = torch.full(s, fill, device=device)
    return params


def served_model(params32: Dict[str, torch.Tensor], cfg: dict,
                 precision: Dict[str, str]) -> gpt2_ref.ServedModel:
    return gpt2_ref.ServedModel(params32, cfg["n_head"], precision)


def flops(cfg: dict) -> SimpleNamespace:
    """``prefill(n, lm_rows)``: a prompt of ``n`` real tokens with
    ``lm_rows`` rows of the lm_head; ``decode(ctx)``: one token over
    ``ctx`` keys (``roofline.prefill_flops`` / ``decode_flops``)."""
    LCV = cfg["n_layer"], cfg["n_embd"], cfg["vocab_size"]
    return SimpleNamespace(
        prefill=lambda n, lm_rows: roofline.prefill_flops(*LCV, n, lm_rows),
        decode=lambda ctx: roofline.decode_flops(*LCV, ctx))


def kernels(cfg: dict) -> Dict[str, tuple]:
    """The parts and flash kernels: each call's bound from the span's live
    lengths (``roofline.parts_call_bound_s``, ``flash_call_bound_s``), and
    one call a layer in every step of a span expected."""
    L, NH = cfg["n_layer"], cfg["n_head"]
    HS = cfg["n_embd"] // NH
    ps = cfg["serving"]["page_size"]

    def expected(r: dict) -> int:
        return L * r.get("steps", 1)

    return {"parts": (KERNELS["parts"], lambda r: roofline.parts_call_bound_s(
                r["lengths"], r["B"], NH, HS, ps), expected),
            "flash": (KERNELS["flash"], lambda r: roofline.flash_call_bound_s(
                r["lengths"], NH, HS), expected)}


def span_targets() -> list:
    """The paged model's three device entries:

    * ``prefill``: ``gpt2_paged.prefill_paged``, a padded admission wave:
      its rows, padded length, the real length of each row (tokens whose
      pool page is a real page) and whether every position is projected;
    * ``chunk``: ``gpt2_paged.decode_chunk_paged``, one link of a decode
      chain: its steps and each live row's committed length (what the
      parts kernel reads in every step of the link);
    * ``step``: ``gpt2_paged.decode_step_paged``, a single-token step:
      each live row's length.
    """
    return [(gpt2_paged, "prefill_paged", "prefill", _describe_prefill),
            (gpt2_paged, "decode_chunk_paged", "chunk", _describe_chunk),
            (gpt2_paged, "decode_step_paged", "step", _describe_step)]


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).cpu()


def _describe_prefill(params, tokens, page, slot, pool, cfg, last_pos=None,
                      **kw):
    pg = _host(page)
    real = (pg < pool.num_pages).sum(dim=1).tolist()
    B, T = pg.shape
    return {"B": int(B), "T": int(T), "lengths": [int(n) for n in real],
            "all_rows": last_pos is None}


def _describe_chunk(params, first_tokens, positions0, *args, num_steps=1,
                    **kw):
    pos0 = _host(positions0)
    return {"B": int(pos0.shape[0]), "steps": int(num_steps),
            "lengths": [int(n) for n in pos0.tolist() if n >= 0]}


def _describe_step(params, tokens, positions, page, slot, block_tables,
                   lengths, *args, **kw):
    ln = _host(lengths)
    return {"B": int(ln.shape[0]), "steps": 1,
            "lengths": [int(n) for n in ln.tolist() if n > 0]}
