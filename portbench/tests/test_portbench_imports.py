"""Nothing of the benchmark imports JAX or the JAX package, and the
references import nothing of the program: module names compared whole at
their top level (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "anakin_tpu", "chip_smoke"}
# out/ holds runs' traces and scratch (ignored by git), not the benchmark
FILES = sorted(os.path.join(r, f) for r, _, fs in os.walk(spec.PKG)
               for f in fs if f.endswith(".py")
               and not (r + os.sep).startswith(spec.OUT + os.sep))


def imported(path):
    """(top-level name, relative level) of every import in a file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, spec.PKG))
def test_no_jax_anywhere(path):
    bad = {name for name, level in imported(path)
           if level == 0 and name in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference"
                                  + os.sep in f],
                         ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_program(path):
    for name, level in imported(path):
        assert name not in FORBIDDEN | {"anakin_tpu_torch", "portbench"}
        assert level <= 1  # only its own package


def test_reference_loads_without_the_program():
    code = ("import sys, portbench.reference.decoder, "
            "portbench.reference.resnet_int8, portbench.inputs; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'anakin_tpu_torch', 'anakin_tpu', 'jax', 'chip_smoke'}; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=spec.ROOT,
                   timeout=120)


def test_run_refuses_without_a_card_and_prints_no_result():
    if os.environ.get("CUDA_VISIBLE_DEVICES") is None:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    else:
        env = dict(os.environ)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "resnet50_int8.offline_b256", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
