"""A family of the tests (``model_type`` "toy"): GPT-2's program under
config keys of another naming, each mapped onto the gpt2 family's. It
shows that a family is a new file the registry finds, with no file of
the harness edited."""

from benchmarks.registry import Registry

GPT2 = Registry().family("gpt2")
REFERENCE, CONTROL = GPT2.REFERENCE, GPT2.CONTROL
# this family's key: GPT-2's
KEYS = {"hidden_size": "n_embd", "num_hidden_layers": "n_layer",
        "num_attention_heads": "n_head",
        "max_position_embeddings": "n_positions"}


def as_gpt2(cfg: dict) -> dict:
    out = {k: v for k, v in cfg.items() if k not in KEYS}
    out.update({g: cfg[k] for k, g in KEYS.items()})
    return out


def program_config(cfg):
    return GPT2.program_config(as_gpt2(cfg))


def engine_config(cfg, concurrency):
    return GPT2.engine_config(as_gpt2(cfg), concurrency)


def make_weights(cfg, seed, device):
    return GPT2.make_weights(as_gpt2(cfg), seed, device)


def served_model(params32, cfg, precision):
    return GPT2.served_model(params32, as_gpt2(cfg), precision)


def flops(cfg):
    return GPT2.flops(as_gpt2(cfg))


def kernels(cfg):
    return GPT2.kernels(as_gpt2(cfg))


def span_targets():
    return GPT2.span_targets()
