"""The benchmark of the PyTorch and CUDA port (``llmc_paged_tpu_torch``):
``python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card."""
