"""The kernel lab (port of llmc_paged_tpu/ops/dev): bench modules that
validate each version of an op against a reference and time it, run as
``python -m llmc_paged_tpu_torch.ops.dev.bench_<x>`` (on the card; on
the CPU with ``--device cpu``)."""
