"""BENCHMARK.json against the contract it is written to, and the harness's
files found by name."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from gsbench import harness

ROOT = harness.ROOT
PKG = harness.PKG
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "hidegs_tpu"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
    n_cells = len(bench["workloads"])
    assert 1 <= n_cells <= 24 and 1 <= len(bench["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, n_cells // 4)


def test_every_cell_config_traffic_and_reader_is_found(bench):
    used = set()
    for w in bench["workloads"]:
        cell = harness.resolve_cell(bench, w["name"])
        harness.driver_module(cell.traffic)
        used.add(w["config"])
        assert w["chips"] in (1, 4)
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("gsbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_names_and_units(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in bench[kind]]
        assert len(names) == len(set(names))
        for m in bench[kind]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_layer_metrics_list_cells_that_report_what_they_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in cells
            e2e, per = harness.cell_metrics(bench, w)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], w)
            assert m["name"] in {p["name"] for p in per}
    for w in cells:
        e2e, per = harness.cell_metrics(bench, w)
        assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2 and per
    for m in bench["per_layer"]:
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def imported_top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(imported_top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported_top_names(path))
    assert "hidegs_tpu_torch" not in names and not names & FORBIDDEN


def test_forbidden_modules_compare_top_level_names_whole():
    assert harness.forbidden_loaded(["hidegs_tpu_torch", "hidegs_tpu_torch.raster", "torch"]) == []
    assert harness.forbidden_loaded(["hidegs_tpu.raster", "jaxlib.xla"]) == ["hidegs_tpu", "jaxlib"]


def test_a_new_cell_and_metric_are_only_new_files(tmp_path, bench):
    """A throwaway configuration, traffic mix, per-layer metric and cell,
    added as new files and new entries, are found by name."""
    pkg = tmp_path / "gsbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests", "reference"))
    cfg = json.loads((PKG / "configs" / "uav-whu-1m.json").read_text())
    cfg["name"] = "toy-config"
    (pkg / "configs" / "toy-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((PKG / "traffic" / "viewer-orbit-1080p.json").read_text())
    traffic["width"] = 640
    (pkg / "traffic" / "toy-traffic.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "toy.frame_count.py").write_text("def read(ctx):\n    return float(len(ctx.spans.get('frame', [])))\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append(dict(bench["configs"][0], name="toy-config", file="gsbench/configs/toy-config.json"))
    new["workloads"].append({"name": "toy-cell", "config": "toy-config", "traffic": "toy-traffic", "chips": 1,
                             "why": "a throwaway cell"})
    new["end_to_end"][[m["name"] for m in new["end_to_end"]].index("lod_frames_per_s")]["workloads"].append("toy-cell")
    new["per_layer"].append({"name": "toy.frame_count", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "device", "moves": "lod_frames_per_s",
                             "workloads": ["toy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.resolve_cell(harness.load_benchmark(tmp_path), "toy-cell", pkg)
    assert cell.config["name"] == "toy-config" and cell.traffic["width"] == 640
    assert "toy.frame_count" in [m["name"] for m in cell.per_layer]

    class Ctx:
        spans = {"frame": [1.0, 2.0]}
    assert harness.load_reader("toy.frame_count", pkg)(Ctx()) == 2.0


@pytest.mark.parametrize("name", sorted(p.stem for p in (PKG / "parked").glob("*.json")))
def test_a_parked_cell_goes_back_as_its_entries(tmp_path, bench, name):
    """A parked cell's entries, added back to BENCHMARK.json as they are,
    meet the same rules and find their files."""
    from gsbench.tests.toy import parked_pkg

    pkg = parked_pkg(tmp_path, name)
    new = harness.load_benchmark(pkg.parent)
    test_names_and_units(new)
    test_layer_metrics_list_cells_that_report_what_they_move(new)
    cell = harness.resolve_cell(new, name, pkg)
    harness.driver_module(cell.traffic)
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"], pkg))
    assert name not in {w["name"] for w in bench["workloads"]}
