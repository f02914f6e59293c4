"""No module of the benchmark loads JAX or the JAX package, and the
yardstick (data, reference, metrics) imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: the data, the references, the metrics, finding files and
#: the traffic's generator
YARDSTICK = ("data/", "reference/", "metrics/", "harness/spec.py", "harness/traffic.py")


def modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                yield os.path.relpath(path, HERE), path


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("rel,path", sorted(modules()))
def test_no_jax_and_the_yardstick_is_apart(rel, path):
    names = top_names(path)
    assert not names & BANNED, f"{rel} imports {sorted(names & BANNED)}"
    if rel.startswith(YARDSTICK):
        assert "repro_torch" not in names, f"{rel} imports the program"


def test_names_are_compared_whole():
    assert "repro_torch" not in BANNED
    assert top_names(os.path.join(HERE, "harness", "port.py")) & {"repro_torch"}
