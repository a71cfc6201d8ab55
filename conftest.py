"""Repository-wide pytest settings.

Fix the str hash seed for every test process. pytest loads this file in
the main process before pytest-xdist starts its workers, and the workers
inherit the environment, so a test that derives a seed from ``hash()``
(``tests/test_paged_attention.py::test_commit_layer_kv_matches_scatter``
seeds its rng with ``hash(mode)``) draws the same inputs in every run.
The assignment overrides an inherited PYTHONHASHSEED on purpose.
"""

import os

os.environ["PYTHONHASHSEED"] = "0"
