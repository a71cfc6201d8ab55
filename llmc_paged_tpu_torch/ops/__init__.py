"""Ops: plain PyTorch layers, int8 weights and the paged-attention kernel."""
