"""The module check, what the harness and the reference import, and the
declarations against the files they name."""

import ast
import json
import os
import re

import pytest

from benchlib import device as devmod
from benchlib.spec import BENCH_DIR, ROOT, find_cell


@pytest.mark.parametrize("mods,bad", [
    ({"jax": 1, "numpy": 1}, ["jax"]),
    ({"jax.numpy": 1}, ["jax"]),
    ({"rnnt_tpu.config": 1}, ["rnnt_tpu"]),
    ({"rnnt_tpu_torch": 1, "rnnt_tpu_torch.serve": 1}, []),
    ({"jaxlib.xla": 1, "flax": 1, "jaxtyping": 1}, ["flax", "jaxlib"]),
])
def test_forbidden_loaded_compares_whole_top_level_names(mods, bad):
    assert devmod.forbidden_loaded(mods) == bad


def imports_of(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub):
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_file_imports_jax_or_the_jax_package():
    for sub in ("benchlib", "drivers", "metrics", "reference", "tools",
                "tests"):
        for path in sources(sub):
            assert not imports_of(path) & set(devmod.FORBIDDEN_MODULES), path
    assert not imports_of(os.path.join(BENCH_DIR, "run.py")) & set(
        devmod.FORBIDDEN_MODULES)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert imports_of(path) <= {"__future__", "typing", "numpy", "torch",
                                    "math"}, path


def spec():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files_and_metrics():
    s = spec()
    for w in s["workloads"]:
        cell = find_cell(w["name"], s)
        assert os.path.exists(os.path.join(BENCH_DIR, "drivers",
                                           cell.driver + ".py"))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                               m["name"] + ".py"))
        assert set(cell.limits) >= {"grad_gap", "change_gap"}


def test_names_units_and_moves():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(s["workloads"]) // 4)
