"""Finding a cell's files by name.

- ``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
- ``port_bench/workloads/<cell>.json`` is a cell: its configuration, its
  traffic mix and the limits of its output check;
- ``port_bench/configs/<config>.json`` is a configuration: its models'
  settings, the world's settings, the compute type and, optionally, its
  ``world_kind`` (``t2`` where it names none);
- ``port_bench/worlds/<kind>.py`` is a world kind (``world_kind``): the
  models it attaches to the port's world, its plain reference, the windows
  and work its stages do, and its stage keys;
- ``port_bench/traffic/<mix>.json`` is a traffic mix: the parameters that
  ``harness/traffic.py``, the one generator, reads;
- ``port_bench/layouts/<pattern>.py`` is where a mix's fresh tiles lie
  (``layout``), named by the mix's ``pattern``;
- ``port_bench/metrics/<metric>.py`` is a metric's reader (``read``).

A later change adds a cell, a configuration, a mix, a layout, a world kind or
a metric by adding its file and its ``BENCHMARK.json`` entry; no file here
names one.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "configs", f"{name}.json"))


def _load(kind: str, name: str, bench_dir: str):
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The metric's ``read(run) -> float | None``."""
    return _load("metrics", name, bench_dir).read


def layout(name: str, bench_dir: str = BENCH_DIR):
    """The layout's ``layout(rng, params) -> (warm tiles, fresh tiles
    factory)``."""
    return _load("layouts", name, bench_dir).layout


def world_kind(config: dict, bench_dir: str = BENCH_DIR):
    """The module of the configuration's world kind, ``worlds/<world_kind>.py``
    (``t2``, the T=2 consistency world, where the configuration names none).
    It defines:

    - ``MODELS``: each model name of the configuration's ``models``, in the
      order their weights are drawn, to the ``WorldPipeline`` attribute that
      holds it once attached (where the tracer hooks it);
    - ``attach(world, models)``: hands the built models to the port's world;
    - ``reference(models, seed, world_cfg, device)``: the plain reference
      world over the reference's models, with ``tile(i1, j1, i2, j2)``,
      ``evaluated`` and ``seconds``;
    - ``windows(world_cfg, boxes) -> {stage: set of window indices}``: the
      stage windows that the served tiles ``boxes`` needed;
    - ``window_flops(model_cfgs, world_cfg) -> {stage: FLOPs of a window}``;
    - ``MODEL_STAGES``: the world's ``stage_timings`` keys of its model
      stages.
    """
    return _load("worlds", config.get("world_kind", "t2"), bench_dir)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    """The traffic mix's parameters."""
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def cell_metrics(bench: dict, cell: str, group: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]
