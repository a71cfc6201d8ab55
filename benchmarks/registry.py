"""Where the harness finds each piece by its name, so that a later cell,
mix, configuration or metric is a new file and no existing file changes:

    configs/<config>.json    a model configuration (BENCHMARK.json's
                             ``configs[].file``)
    mixes/<traffic>.json     a traffic mix: a generator ``kind`` and its
                             parameters
    traffic/<kind>.py        a generator kind (``Traffic`` class)
    cells/<workload>.json    a cell's concurrency, trace slice and the
                             limits of its correctness comparison
    metrics/<metric>.py      a metric's ``compute(record)``
    families/<model_type>.py a model family: everything the harness knows
                             of a model (``families/gpt2.py`` lists it),
                             found by a config file's ``model_type``
                             (``DEFAULT_MODEL_TYPE`` where it has none)

Lookups search the registry's directories in order, so a test can lay a
directory of its own files over the benchmark's.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
# the family of a config file that names none
DEFAULT_MODEL_TYPE = "gpt2"


class Registry:
    def __init__(self, dirs: Sequence[str] = (HERE,)):
        self.dirs: List[str] = list(dirs)

    def path(self, sub: str, name: str, ext: str) -> str:
        for d in self.dirs:
            p = os.path.join(d, sub, name + ext)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(f"no {sub}/{name}{ext} under {self.dirs}")

    def _json(self, sub: str, name: str) -> dict:
        with open(self.path(sub, name, ".json")) as f:
            return json.load(f)

    def _module(self, sub: str, name: str):
        p = self.path(sub, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmarks_{sub}_{name}".replace(".", "_").replace("-", "_"),
            p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def mix(self, name: str) -> dict:
        return self._json("mixes", name)

    def cell(self, name: str) -> dict:
        return self._json("cells", name)

    def traffic(self, kind: str):
        return self._module("traffic", kind)

    def metric(self, name: str):
        return self._module("metrics", name)

    def family(self, model_type: str):
        return self._module("families", model_type)

    def family_of(self, cfg: dict):
        """The family of a configuration: its ``model_type``'s module. An
        unknown type raises, naming the file looked for."""
        return self.family(cfg.get("model_type", DEFAULT_MODEL_TYPE))
