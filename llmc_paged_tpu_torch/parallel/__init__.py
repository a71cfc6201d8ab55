"""Tensor and data parallelism over torch.distributed (port of
llmc_paged_tpu/parallel/): ``sharding`` holds the mesh, the TP layout,
the TP step builders and the DP train step; ``mp_dryrun`` the launcher
of rank processes and the multi-process dry run."""

from llmc_paged_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    init_distributed,
    init_tp_pool,
    make_dp_train_step,
    make_mesh,
    make_tp_decode_chunk,
    make_tp_decode_chunk_spec,
    make_tp_decode_step,
    make_tp_prefill,
    make_tp_prefill_suffix,
    prepare_tp_params,
)
