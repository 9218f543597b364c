"""BENCHMARK.json against the benchmark's contract, and the import guard."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "rtbench/run.py"]
    assert bench["paths"] == ["rtbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank"))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_file_a_cell_names_resolves(bench):
    wl = {w["name"] for w in bench["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("rtbench/")
        cfg = json.loads(path.read_text())
        assert (HERE / "references" / f"{cfg['reference']}.py").is_file()
    for name in wl:
        cell = harness.load_cell(name, bench)
        assert (HERE / "traffic" / f"{cell.traffic['kind']}.py").is_file()
        assert cell.rate is not None and cell.rate > 0
        for m in cell.end_to_end + cell.per_layer:
            assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], m
        if m["name"].endswith(("_roofline", "_roofline.rt")) or \
                "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)


def test_published_widths_are_the_sizes_run(bench):
    """The configuration file's published keys and the sizes the harness
    builds from agree wherever the port has the quantity."""
    pairs = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "num_hidden_layers": "num_layers",
             "moe_intermediate_size": "moe_d_ff",
             "n_routed_experts": "num_experts",
             "num_experts_per_tok": "experts_per_token",
             "n_shared_experts": "num_shared_experts",
             "first_k_dense_replace": "num_dense_layers",
             "rope_theta": "rope_theta"}
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for src, port in pairs.items():
            if src in cfg:
                assert cfg[src] == cfg["model"][port], (c["name"], src)
        tie = cfg.get("tie_word_embeddings")
        assert tie is None or tie == cfg["model"]["tie_embeddings"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` begins with
    ``repro`` and is allowed."""
    for path in HERE.rglob("*.py"):
        for mod in _imports(path):
            assert not harness.forbidden(mod), (path, mod)
        if not path.name.startswith("test_"):
            assert "benchmarks" not in path.read_text(), path


def test_a_run_loads_neither():
    """What a run imports, from the harness down to the program's engine,
    in a fresh process: no top-level name of ``harness.FORBIDDEN``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness, check, counting, devtrace, weights\n"
        "from repro_torch.serving import engine, generate\n"
        "from repro_torch.core import scheduler\n"
        "from repro_torch.obs import Observability\n"
        "harness.load_module(harness.HERE / 'references' / 'decoder.py', "
        "'r')\n"
        "print(','.join(harness.forbidden_modules()))\n"
        % (str(HERE), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("module,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.models.model", True),
    ("repro_torch", False), ("repro_torch.serving.engine", False),
    ("jaxtyping", False), ("reprobe", False)])
def test_forbidden_names_compare_whole(module, bad):
    assert harness.forbidden(module) is bad
