"""BENCHMARK.json against the shape the benchmark keeps to, and everything it names
found by name."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from gpubench.harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
B = bench.benchmark()


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["gpubench"] and B["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in B[kind]]
    assert len(names) == len(set(names))
    for e in B[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    if kind == "workloads":
        for e in B[kind]:
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_parts_load_by_name(cell):
    c, config, traffic = bench.cell_parts(cell)
    assert config["name"] == c["config"]
    mode = bench.mode_module(traffic)
    for name in ("make_inputs", "load_libraries", "Mode", "reference"):
        assert callable(getattr(mode, name)), name
    entry = next(x for x in B["configs"] if x["name"] == c["config"])
    assert entry["file"] == f"gpubench/configs/{c['config']}.json"
    assert set(entry["reduced"]) == set(config["reduced"])
    assert entry["source"] == config["source"]
    e2e = [m for m in B["end_to_end"] if cell in m.get("workloads", [cell])]
    per = [m for m in B["per_layer"] if cell in m.get("workloads", [cell])]
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2 and per


@pytest.mark.parametrize("metric", [m["name"] for m in B["end_to_end"] + B["per_layer"]])
def test_metric_readers_load_by_name(metric):
    assert callable(bench.metric_reader(metric).read)


def test_per_layer_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells


def test_rooflines_load_by_name():
    for m in B["per_layer"]:
        if m["name"].endswith(bench.KERNEL_METRIC_SUFFIX):
            rl = bench.roofline(m["name"][:-len(bench.KERNEL_METRIC_SUFFIX)])
            assert rl.MODULE.startswith("nanosim_tpu_torch.") and rl.TRACE_NAME


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(sub=""):
    base = os.path.join(bench.HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_sources_import_no_jax_and_reference_nothing_of_the_program():
    for path in _py_files():
        for name in _imports(path):
            assert name.split(".")[0] not in bench.BANNED, (path, name)
    for path in _py_files("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "nanosim_tpu_torch", (path, name)


def test_loaded_modules_have_no_banned_top_level_name():
    """What a run imports, in a process of its own: the harness, the mode,
    the port's modules the mode loads, the reference."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench.harness import bench, trace, judge\n"
        "from gpubench.modes import genome\n"
        "import gpubench.control\n"
        "import nanosim_tpu_torch.sim.genome_mode, nanosim_tpu_torch.sim.chimeric_mode\n"
        "import nanosim_tpu_torch.sim.unaligned_mode, nanosim_tpu_torch.io.native\n"
        "import nanosim_tpu_torch.ops.walk_cuda, nanosim_tpu_torch.ops.gather_cuda\n"
        "from gpubench.reference import oracle\n"
        "print(bench.banned_modules(sys.modules))\n"
        "ref = [m for m in sys.modules if m.startswith('gpubench.reference')]\n"
        "print(len(ref))\n"
    ) % bench.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split("\n")
    assert out[0] == "[]" and int(out[1]) > 5
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gpubench.reference import oracle\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nanosim_tpu_torch', 'nanosim_tpu', 'jax', 'jaxlib', 'flax'}))\n") % bench.ROOT
    assert subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True).stdout.strip() == "[]"


def test_banned_modules_compare_whole_top_level_names():
    assert bench.banned_modules(["nanosim_tpu_torch.sim", "jaxtyping", "numpy"]) == []
    assert bench.banned_modules(["nanosim_tpu.sim", "jax.numpy", "jaxlib"]) == [
        "jax.numpy", "jaxlib", "nanosim_tpu.sim"]
