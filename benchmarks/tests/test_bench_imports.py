"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their whole top-level name: the port's name begins with the JAX
package's."""

import ast
import os
import subprocess
import sys

from benchmarks.registry import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "llmc_paged_tpu"}
PROGRAM = "llmc_paged_tpu_torch"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules(HERE)}
    assert not {p: m for p, m in found.items() if m}


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for p in _modules(ref):
        names = set(_imports(p))
        assert PROGRAM not in names, p
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "torch"}, (p, names)


def test_a_run_loads_no_jax_module():
    # what the harness and the program load in a fresh interpreter
    code = ("import sys; from benchmarks import harness, spans, control; "
            "from benchmarks.run import forbidden_loaded; "
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), check=True)
    assert out.stdout.strip() == "[]"


def test_whole_names_are_compared():
    from benchmarks.run import FORBIDDEN as RUN_FORBIDDEN
    assert PROGRAM.split(".")[0] not in RUN_FORBIDDEN
    assert "llmc_paged_tpu" in RUN_FORBIDDEN
