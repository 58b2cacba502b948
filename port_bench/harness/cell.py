"""One run of one cell: set-up, warm-up, the measured window, the traced
readings, the output check and the result line."""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np
import torch

from harness import check, load, registry, traffic, weights, work
from harness.program import Server, build_models

FORBIDDEN = {"jax", "jaxlib", "flax", "terrain_diffusion_tpu"}
SAMPLE_TILES = 4           # tiles of a run compared with the reference, drawn ...
SAMPLE_FROM = 8            # ... from the last ones served
PROFILE_SECONDS = 3.0      # the profiled part of a traced run, after its window ...
PROFILE_CAP = 120.0        # ... under load until the profiler has stopped, at most this
HOST_STAGE_KEYS = ("compose", "fetch", "prefetch")  # logged after the kind's model stages


class NoCard(RuntimeError):
    pass


def seeds(seed: int) -> dict:
    """The run's independent seeds, all drawn from ``--seed``."""
    s = np.random.SeedSequence(int(seed) & 0xFFFFFFFFFFFFFFFF).generate_state(8)
    return {"weights": int(s[0]) << 32 | int(s[1]), "world": int(s[2]) << 32 | int(s[3]),
            "traffic": int(s[4]), "sample": int(s[5])}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class Phases:
    """Host-clock marks of a run's phases, logged as they pass."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0

    def __call__(self, name: str):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - self.last:.3f} s (at {now - self.t0:.3f} s)")
        self.last = now


def stage_totals(world) -> dict:
    return {k: v[1] for k, v in world.stage_timings.items()}


def launch_counts() -> dict:
    from terrain_diffusion_tpu_torch.ops import attention, fused_block

    return {"fused_block": fused_block.fused_block.launches,
            "conv3x3": fused_block.conv3x3.launches,
            "attention": attention.fused_pixelnorm_attention.launches}


def serve(name: str, seed: int, seconds: float, trace: bool, *, t_process: float,
          device: str = "cuda", workload: dict | None = None, config: dict | None = None,
          mix: dict | None = None, bench: dict | None = None,
          bench_dir: str = registry.BENCH_DIR) -> dict:
    """Set-up, warm-up, the window (and with ``trace`` the profiled part),
    then the program's side of the output check, and the program freed.
    Raises ``NoCard`` without the chips the cell asks for.  ``workload``,
    ``config``, ``mix`` (the traffic) and ``bench`` replace the files found by
    name (the CPU tests' small cells); ``bench_dir`` is where the files are
    found."""
    bench = bench if bench is not None else registry.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    wl = workload if workload is not None else registry.workload(name, bench_dir)
    cfg = config if config is not None else registry.config(entry["config"], bench_dir)
    kind = registry.world_kind(cfg, bench_dir)
    if set(cfg["models"]) != set(kind.MODELS):
        raise ValueError(f"the configuration's models {sorted(cfg['models'])} are not its "
                         f"world kind's {list(kind.MODELS)}")
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < entry["chips"]):
        raise NoCard(f"{name} needs {entry['chips']} CUDA device(s); "
                     f"torch.cuda.is_available()={torch.cuda.is_available()}")
    phase = Phases(t_process)
    phase("imports")
    sd = seeds(seed)
    dtype = cfg["dtype"]
    mix = mix if mix is not None else registry.traffic(entry["traffic"], bench_dir)
    plan = traffic.plan(sd["traffic"], mix, registry.layout(mix["pattern"], bench_dir))

    # -- set-up: weights, the world behind its server, the cell's shapes warmed
    states = weights.make(cfg["models"], sd["weights"], device, kind.MODELS)
    models = build_models(cfg["models"], states, device)
    phase("weights and models")
    server = Server(models, kind.attach, cfg["world"], sd["world"],
                    None if dtype == "fp32" else dtype, device)
    world = server.world
    phase("world bound, server up")
    # the first warm-up batch is the clients' tiles in one coalesced call, the
    # largest a cold start makes: the peak memory is reached in set-up
    server.pipeline.get_many(plan.warm[:plan.clients], with_climate=True, pack_wire=True)
    warm = load.drive(server.port, plan.warm[plan.clients:], plan.clients, keep_bodies=False)
    bad = [r.error for r in warm if not r.ok]
    if bad:
        raise RuntimeError(f"warm-up requests failed: {bad[:3]}")
    if device == "cuda":
        torch.cuda.synchronize()
    phase(f"warm-up ({len(plan.warm)} tiles)")
    tracer = None
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    deadline = t_start + seconds
    before, launches0 = stage_totals(world), launch_counts()
    until = None
    if trace:  # the profiled part follows the measured one, under the same load
        from harness.trace import Tracer

        tracer = Tracer(world, kind.MODELS, deadline, deadline + PROFILE_SECONDS,
                        snapshot=lambda: (stage_totals(world), launch_counts()))
        deadline += PROFILE_CAP
        until = lambda: tracer.profiled  # noqa: E731

    # -- the window
    records = load.run_window(server.port, plan, t_start, deadline, until)
    t_stop = tracer.t_prof if tracer is not None else None
    stats = load.window_stats(records, t_start, t_stop)
    phase(f"window ({stats['tiles']} tiles)")
    if device == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    after, launches1, rows, forwards = (
        tracer.at_prof if t_stop is not None
        else (stage_totals(world), launch_counts(), None, None))
    stage_delta = {k: after[k] - before.get(k, 0.0) for k in after}
    launches = {k: v - launches0[k] for k, v in launches1.items()}
    served = [r.box for r in records if r.ok and (t_stop is None or r.t1 <= t_stop)]
    geo = kind.windows(cfg["world"], served)
    per_window = kind.window_flops(cfg["models"], cfg["world"])
    run = {"window": stats, "setup_s": setup_s, "peak_bytes": peak,
           "stage_delta": stage_delta, "model_stages": tuple(kind.MODEL_STAGES),
           "spans": [], "trace": None, "roofline": {},
           "useful_flops": work.useful_flops(geo, per_window),
           "peak_flops": work.PEAK_FLOPS[dtype]}
    breakdown = None
    if tracer is not None:
        if tracer.prof is not None and not tracer.profiled:
            server.pipeline._coalescer.run(lambda _w: tracer.stop())
        tracer.close()
        run["spans"] = [s for s in tracer.spans if s[0] >= t_start and s[1] <= t_stop]
        reduced = None
        chrome = tracer.chrome_trace()
        if chrome is not None:
            from harness.trace import reduce_trace

            reduced = reduce_trace(chrome)
            del chrome
        run["trace"] = reduced
        if reduced is not None:
            breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
            for model, (dev_s, shapes) in reduced["model_device_s"].items():
                if dev_s > 0:
                    roof = sum(work.roofline_s(cfg["models"][model], n, h, dtype)
                               for n, h in shapes)
                    run["roofline"][model] = 100.0 * roof / dev_s
        phase("trace read")
        tiles = max(stats["tiles"], 1)
        log(f"[trace] card {card_line()}; {stats['tiles']} tiles in {stats['window_s']:.3f} s")
        log("[trace] kernel launches per tile: " + ", ".join(
            f"{k} {v / tiles:.3f}" for k, v in launches.items()))
        log("[trace] stage ms per tile: " + ", ".join(
            f"{k} {1e3 * stage_delta.get(k, 0.0) / tiles:.2f}"
            for k in run["model_stages"] + HOST_STAGE_KEYS))
        log("[trace] windows needed by the served tiles: " + ", ".join(
            f"{k} {len(v)}" for k, v in geo.items()) + "; rows the models ran: " + ", ".join(
            f"{k} {v}" for k, v in (rows or tracer.rows).items()) + "; forwards: " + ", ".join(
            f"{k} {v}" for k, v in (forwards or tracer.forwards).items()))

    # -- the program's side of the output check; then the program is freed
    failed = sum(not r.ok for r in records)
    sample = check.sample_boxes(records, sd["sample"], SAMPLE_TILES, SAMPLE_FROM)
    got = check.program_tiles(world, sample)
    phase("program side of the check")
    server.stop_http()
    server.close()
    out = {"name": name, "bench": bench, "bench_dir": bench_dir, "entry": entry, "workload": wl,
           "config": cfg, "kind": kind, "seeds": sd, "states": states, "run": run,
           "breakdown": breakdown, "got": got,
           "boxes": [r.box for r in sample], "attempted": len(records), "failed": failed,
           "device": device, "phase": phase}
    del server, world, models, records, tracer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def reference(served: dict, quant: str = "none") -> list:
    """The reference's tiles of the served sample (``quant``: the control)."""
    cfg = served["config"]
    return check.reference_tiles(served["kind"], cfg["models"], served["states"], cfg["world"],
                                 served["seeds"]["world"], served["boxes"], served["device"],
                                 quant)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_process: float,
             **kw) -> dict:
    """The result line of one run (a dict); see ``serve``."""
    served = serve(name, seed, seconds, trace, t_process=t_process, **kw)
    got, failed, run = served["got"], served["failed"], served["run"]
    readings = {}
    if got:
        readings = check.compare(got, reference(served))
        readings.update(check.compare_compose(got, check.composed_from_program(
            got, served["boxes"], served["config"]["world"], served["device"])))
    served["phase"]("reference")
    limits = served["workload"]["limits"]
    correct = bool(got) and check.judge(readings, limits) and failed == 0
    device, trace_red = served["device"], run["trace"]

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        raise RuntimeError(f"modules loaded in the benchmark's process: {loaded}")

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(served["bench"], name, group):
        v = registry.metric_reader(m["name"], served["bench_dir"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": served["entry"]["chips"], "memory_peak_bytes": int(run["peak_bytes"])}
    if trace and trace_red is not None:
        dev["busy_s"] = trace_red["busy_s"]
        dev["window_s"] = trace_red["window_s"]
    line = {"correct": correct, "attempted": served["attempted"], "failed": failed,
            "metrics": metrics, "device": dev}
    if served["breakdown"] is not None:
        line["breakdown"] = served["breakdown"]
    line["checks"] = {k: {"value": readings.get(k), "limit": limits[k]} for k in limits}
    log("[readings] " + ", ".join(f"{k} {v:.4g}" for k, v in readings.items()))
    for k in limits:
        log(f"[check] {k} {readings.get(k)} limit {limits[k]}")
    return line
