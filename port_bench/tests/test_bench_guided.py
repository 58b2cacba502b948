"""The guided world kind (``worlds/guided.py``): its windows and work against
hand counts, its reference tiles against ``GuidedRefWorld``, and a tiny
guided cell through ``run_cell`` on the CPU."""
import collections
import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, tiny_config, tiny_mix
from harness import check, registry, weights

CELL = "world90-guided-bf16.walk"


def _guided_config(steps: int = 2) -> dict:
    """The cell's configuration at tiny widths, the guide narrower than the
    base, and ``steps`` DPM-Solver++ steps a latent window."""
    cfg = tiny_config("world90-guided-bf16")
    cfg["models"]["guide"].update(model_channels=4, attn_resolutions=[],
                                  block_kwargs={"channels_per_head": 4})
    cfg["world"]["latent_steps"] = steps
    return cfg


def test_the_guided_kind_counts_windows_and_work_by_hand():
    """One 256-px tile at the origin of the configuration's world (latent
    compression 8, decoder windows 512 at stride 384): the elevation reads
    residual rows [-48, 312) and latent rows [-6, 39) in each axis, so
    decoder windows -1..0 and latent windows -2..1; the two decoder windows'
    latent arguments, rows [-48, 16) and [0, 64), add latent windows -3 and
    -1..1: 5 x 5 latent windows.  Their coarse contexts (rows [s - 1, s + 3))
    and the climate's coarse rows [-8, 10) lie in coarse windows -1..0: 2 x
    2.  No init layer."""
    cfg = registry.config("world90-guided-bf16")
    kind = registry.world_kind(cfg)
    assert kind.MODEL_STAGES == ("coarse", "latent_dpm", "decoder")
    got = kind.windows(cfg["world"], [(0, 0, 256, 256)])
    rng = lambda a, b: range(a, b + 1)  # noqa: E731
    assert got["decoder"] == {(0, i, j) for i in rng(-1, 0) for j in rng(-1, 0)}
    assert got["latent_dpm"] == {(0, i, j) for i in rng(-3, 1) for j in rng(-3, 1)}
    assert got["coarse"] == {(0, i, j) for i in rng(-1, 0) for j in rng(-1, 0)}
    # a forward of the 192-channel base and of the 128-channel guide on a 64-px
    # window: 193.6 and 86.1 GFLOP (the T=2 kind's base count is frozen in
    # test_bench_world_kinds.py); 15 steps of both a latent window
    flops = kind.window_flops(cfg["models"], cfg["world"])
    assert flops == {"coarse": 430209761280.0,
                     "latent_dpm": 15 * (193621131264.0 + 86091235328.0),
                     "decoder": 1375631048704.0}
    no_guide = dict(cfg["world"], guidance_scale=1.0)
    assert kind.window_flops(cfg["models"], no_guide)["latent_dpm"] == 15 * 193621131264.0


def test_the_guided_reference_tiles_are_the_guided_reference_worlds():
    from reference.guided_world import GuidedRefWorld
    from reference.unet import UNet

    cfg = _guided_config()
    kind = registry.world_kind(cfg)
    assert list(kind.MODELS) == ["coarse", "base", "guide", "decoder"]
    states = weights.make(cfg["models"], 2 ** 31 + 9, "cpu", kind.MODELS)
    boxes = [(0, 0, 32, 32), (96, -64, 128, -32)]
    got = check.reference_tiles(kind, cfg["models"], states, cfg["world"], 77, boxes, "cpu")
    models = {}
    for s, mc in cfg["models"].items():
        models[s] = UNet(mc, device="cpu")
        models[s].load_state_dict(states[s])
    ref = GuidedRefWorld(models["coarse"], models["base"], models["guide"], models["decoder"],
                         77, cfg["world"], "cpu")
    assert set(ref.win) == {"coarse", "step", "decoder"}
    with torch.no_grad():
        for g, box in zip(got, boxes):
            want = ref.tile(*box)
            want["wire_elev"] = want["wire_elev"].float()
            want["climate"] = want["climate"][:4]
            assert g.keys() == want.keys()
            for k in want:
                assert torch.equal(g[k], want[k]), (box, k)
    with pytest.raises(ValueError, match="latent_sampler"):
        GuidedRefWorld(models["coarse"], models["base"], models["guide"], models["decoder"],
                       77, dict(cfg["world"], latent_sampler="consistency"), "cpu")


def _cpu_reduce(trace: dict) -> dict:
    """``reduce_trace`` on the CPU, where the profiler sees no card: each
    model's host time in its ``bench.fwd.*`` ranges stands for its device
    time."""
    model = collections.defaultdict(lambda: [0.0, []])
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("bench.fwd."):
            _, _, name, n, h, _w = e["name"].split(".")
            model[name][0] += e["dur"] * 1e-6
            model[name][1].append((int(n), int(h)))
    return {"busy_s": 1.0, "window_s": 2.0, "device_ops": [], "idle_gaps": [],
            "model_device_s": dict(model)}


def test_a_tiny_guided_cell_runs_correct(monkeypatch, capfd):
    from harness import trace
    from harness.cell import run_cell

    monkeypatch.setattr(trace, "reduce_trace", _cpu_reduce)
    line = run_cell(CELL, 2 ** 31 + 29, 12.0, True, t_process=time.perf_counter(),
                    device="cpu", config=_guided_config(), mix=tiny_mix(CELL))
    err = capfd.readouterr().err
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["guide_fwd_roofline"] > 0 and m["base_fwd_roofline"] > 0
    assert 0 < m["stage_ms_per_tile.latent_dpm"] <= m["stage_ms_per_tile.models"]
    rows = next(ln for ln in err.splitlines() if "rows the models ran:" in ln)
    ran = dict(p.split() for p in rows.split("rows the models ran: ")[1].split(";")[0].split(", "))
    assert int(ran["guide"]) > 0 and ran["guide"] == ran["base"]
    stages = next(ln for ln in err.splitlines() if "[trace] stage ms per tile:" in ln)
    assert [p.split()[0] for p in stages.split(": ", 1)[1].split(", ")] == [
        "coarse", "latent_dpm", "decoder", "compose", "fetch", "prefetch"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_control_fails_and_program_passes_in_the_guided_cell(card):
    """On the card, at the cell's own size (one seed, a short window); runs
    with ``python -m pytest -q -p no:cacheprovider port_bench/tests -m cuda``."""
    out = subprocess.run([sys.executable, "port_bench/control.py", "--workload", CELL,
                          "--seconds", "4", "--seeds", str(2 ** 31 + 78)],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    reading = json.loads(out.stdout.strip().splitlines()[-1])
    limits = registry.workload(CELL)["limits"]
    assert all(reading["program"][k] <= v for k, v in limits.items()), reading
    assert any(reading["control_reading"][k] > v for k, v in limits.items()), reading
