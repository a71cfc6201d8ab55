"""Process start to the window's opening: imports, CUDA, weights from the
seed, the engine, the kernels' build on a checkout's first run, and the
ramp of the traffic to its steady mix."""


def compute(record):
    return record["setup_s"]
