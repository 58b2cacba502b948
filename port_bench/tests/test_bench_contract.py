"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell's files by name (a cell and a metric added as files alone)."""
import itertools
import json
import os
import re

from conftest import BENCH_DIR, ROOT
from harness import registry, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"][1] == "port_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_entry_has_exactly_the_contract_keys():
    entries = {
        "configs": ({"name", "source", "file", "reduced", "why"}, set()),
        "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
        "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
        "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
    }
    for section, (required, optional) in entries.items():
        for entry in BENCH[section]:
            assert required <= set(entry) <= required | optional, (section, entry["name"])
    for c in BENCH["configs"]:
        assert _one_line(c["why"]) and _one_line(c["source"]) and len(c["reduced"]) <= 16
    assert all(_one_line(word) for word in BENCH["command"]) and len(BENCH["command"]) <= 32
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert all(_one_line(m["layer"]) for m in BENCH["per_layer"])


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(n for n in names[:len(BENCH["configs"]) + len(BENCH["workloads"])])) == \
        len(BENCH["configs"]) + len(BENCH["workloads"])
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] in (1, 4)


def test_bounds_and_metric_fields():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    assert len(layers) >= 4


def test_every_cell_finds_its_files_by_name():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("port_bench/")
        cfg = registry.config(c["name"])
        assert cfg["models"].keys() == registry.world_kind(cfg).MODELS.keys()
    for w in BENCH["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert callable(registry.layout(registry.traffic(w["traffic"])["pattern"]))
        assert registry.cell_metrics(BENCH, w["name"], "per_layer")
        names = {m["name"] for m in registry.cell_metrics(BENCH, w["name"], "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_a_cell_and_a_metric_added_as_files_only_are_found(tmp_path):
    for sub in ("workloads", "traffic", "metrics", "configs", "layouts"):
        (tmp_path / sub).mkdir()
    (tmp_path / "workloads" / "world90-f32.dummy.json").write_text(json.dumps(
        {"config": "world90-f32", "traffic": "dummy", "limits": {}}))
    # a mix as data alone: the walk, a quarter of it revisits, in open-loop bursts
    (tmp_path / "traffic" / "dummy.json").write_text(json.dumps(
        {"pattern": "walk", "tile": 64, "width": 2, "clients": 1, "warm_rows": 1,
         "warm_cells": 4, "grid_span": 2, "revisit": 0.25,
         "arrival": {"kind": "open", "rate": 3.0, "burst": 3}}))
    (tmp_path / "metrics" / "dummy_ms.py").write_text(
        "def read(run):\n    return run['x'] * 2\n")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "world90-f32.dummy", "config": "world90-f32", "traffic": "dummy", "chips": 1,
         "why": "a test"}],
        per_layer=BENCH["per_layer"] + [
        {"name": "dummy_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "device", "moves": "tiles_per_s", "workloads": ["world90-f32.dummy"]}])
    wl = registry.workload("world90-f32.dummy", bench_dir=str(tmp_path))
    plan = traffic.plan(7, registry.traffic(wl["traffic"], bench_dir=str(tmp_path)))
    assert len(plan.warm) == 2 and plan.clients == 1
    assert all(i2 - i1 == 64 for i1, _, i2, _ in plan.warm)
    assert plan.arrivals() is not None
    tiles = list(itertools.islice(plan.tiles(), 400))
    assert 0.15 < 1 - len(set(tiles)) / len(tiles) < 0.35
    # a layout added as a file (a benchmark change), found by the mix's pattern
    (tmp_path / "layouts" / "column.py").write_text(
        "def layout(rng, p):\n"
        "    t = p['tile']\n"
        "    return [], lambda: ((k * t, 0, k * t + t, t) for k in range(5))\n")
    col = traffic.plan(7, {"pattern": "column", "tile": 32, "clients": 2},
                       layout=registry.layout("column", bench_dir=str(tmp_path)))
    assert list(col.tiles()) == [(k * 32, 0, k * 32 + 32, 32) for k in range(5)]
    assert registry.metric_reader("dummy_ms", bench_dir=str(tmp_path))({"x": 2.5}) == 5.0
    names = [m["name"] for m in registry.cell_metrics(bench, "world90-f32.dummy", "per_layer")]
    assert "dummy_ms" in names and "mfu" in names
    assert "dummy_ms" not in [m["name"] for m in
                              registry.cell_metrics(bench, "world90-f32.walk", "per_layer")]
    assert BENCH_DIR != str(tmp_path)
