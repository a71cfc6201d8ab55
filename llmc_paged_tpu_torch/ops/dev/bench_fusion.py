"""Elementwise-op fusion lab, port of llmc_paged_tpu/ops/dev/bench_fusion.py
(it covers the reference's remaining kernel files, dev/cuda:
positional_forward, residual_forward, gelu_forward, crossentropy_forward,
crossentropy_softmax_backward, in one sweep).

The JAX lab measures "ops dispatched separately" against "ops in one
jit". Eager PyTorch fuses nothing, so here the MLP tail is the port's
own ops (the linear, the composite tanh GELU of ``ops/layers``, the
residual add: one kernel each, the GELU several) against the same tail
with PyTorch's one-kernel tanh GELU: the gap is what fusing the GELU's
elementwise chain would buy. The cross entropy is softmax-then-log (the
reference's two-kernel chain, train_gpt2.c:398-441) against the
log-softmax NLL ``ops/layers.softmax_cross_entropy``.

Run: python -m llmc_paged_tpu_torch.ops.dev.bench_fusion [--device cpu]
     [--iters N]
"""

from __future__ import annotations

import torch

from llmc_paged_tpu_torch import resolve_device
from llmc_paged_tpu_torch.ops.dev.harness import parse_args, sweep
from llmc_paged_tpu_torch.ops.layers import (
    gelu_tanh,
    linear,
    softmax_cross_entropy,
)


def make_args(R, C, V, device):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(R, C, generator=g, device=device)
    w = torch.randn(4 * C, C, generator=g, device=device) * 0.02
    res = torch.randn(R, 4 * C, generator=g, device=device)
    logits = torch.randn(R, V, generator=g, device=device)
    targets = torch.randint(0, V, (R,), generator=g, device=device)
    return x, w, res, logits, targets


def _mlp_tail(x, w, res):
    return gelu_tanh(linear(x, w)) + res


def _mlp_tail_fused_gelu(x, w, res):
    return torch.nn.functional.gelu(linear(x, w), approximate="tanh") + res


def _ce_two_pass(lg, t):
    p = torch.softmax(lg, dim=-1)
    return -torch.log(p.gather(1, t[:, None])[:, 0]).mean()


def _ce_fused(lg, t):
    return softmax_cross_entropy(lg[None], t[None])


VERSIONS = {
    "mlp_tail_port_ops": (lambda x, w, res, lg, t: _mlp_tail(x, w, res),
                          {"validate": False}),
    "mlp_tail_fused_gelu": (lambda x, w, res, lg, t:
                            _mlp_tail_fused_gelu(x, w, res),
                            {"validate": False}),
    "xent_softmax_then_log": (lambda x, w, res, lg, t: _ce_two_pass(lg, t),
                              {"validate": False}),
    "xent_fused_logsumexp": (lambda x, w, res, lg, t: _ce_fused(lg, t),
                             {"validate": False}),
}

CONFIGS = [
    (8, 768, 50304),      # decode rows
    (1024, 768, 50304),   # prefill rows
    (4096, 768, 50304),
]


def main(argv=None):
    a = parse_args(argv)
    # the two pairs against each other once
    x, w, res, lg, t = make_args(64, 768, 50304,
                                 device=resolve_device(a.device))
    torch.testing.assert_close(_mlp_tail_fused_gelu(x, w, res),
                               _mlp_tail(x, w, res), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(_ce_two_pass(lg, t), _ce_fused(lg, t),
                               rtol=1e-5, atol=0.0)
    print("[validate] fused == unfused OK (both pairs)")
    del x, w, res, lg, t
    return sweep(VERSIONS, make_args, CONFIGS,
                 ref_name="mlp_tail_port_ops", iters=a.iters,
                 device=a.device)


if __name__ == "__main__":
    main()
