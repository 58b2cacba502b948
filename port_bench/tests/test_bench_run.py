"""The command without a card, and the whole run on a small world on the CPU
(the harness's look for a card skipped): correct when sound, not correct
under each fault a cell of this benchmark can have."""
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH_DIR, ROOT, tiny_config, tiny_mix

CMD = [sys.executable, "port_bench/run.py", "--workload", "world90-f32.walk", "--seed",
       str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(CMD, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_command_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(CMD, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _run(name="world90-f32.walk", trace=False, mix=None):
    from harness.cell import run_cell

    return run_cell(name, 2 ** 31 + 11, 1.5, trace, t_process=time.perf_counter(),
                    device="cpu", mix=dict(tiny_mix(name), **(mix or {})),
                    config=tiny_config(name.rsplit(".", 1)[0]))


# an open loop in bursts, half of it returning to tiles already served
OPEN_REVISIT = {"revisit": 0.5, "revisit_lag": 4,
                "arrival": {"kind": "open", "rate": 8.0, "burst": 2, "gaps": "poisson"}}


@pytest.mark.parametrize("name,trace,mix", [("world90-f32.walk", True, None),
                                            ("world90-f32.scatter", False, None),
                                            ("world90-bf16.walk", False, None),
                                            ("world90-bf16.walk", False, OPEN_REVISIT)])
def test_a_sound_run_is_correct(name, trace, mix):
    line = _run(name, trace, mix)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    group = "queries_per_batch" if trace else "tiles_per_s"
    assert group in line["metrics"]


def _step_unchanged(mp):
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    orig = WorldPipeline._latent_core

    def core(self, t_value, seed_offset, with_prev, *args, **kwargs):
        f = orig(self, t_value, seed_offset, with_prev, *args, **kwargs)
        return (lambda ctxs, coarses, prevs=None: prevs) if with_prev else f

    mp.setattr(WorldPipeline, "_latent_core", core)


def _half_batch_left_out(mp):
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    orig = WorldPipeline._forward

    def forward(self, model, x, labels, cond, *args, **kwargs):
        out = orig(self, model, x, labels, cond, *args, **kwargs)
        h = out.shape[0] // 2
        if h:
            out = torch.cat([out[:h], out[:h].mean(0, keepdim=True).expand_as(out[h:])])
        return out

    mp.setattr(WorldPipeline, "_forward", forward)


def _answer_altered(mp):
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    orig = WorldPipeline._elev_core

    def elev_core(self, *args, **kwargs):
        return orig(self, *args, **kwargs) + 100.0  # every composed tile 100 m high

    mp.setattr(WorldPipeline, "_elev_core", elev_core)


def _climate_altered(mp):
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    orig = WorldPipeline._climate_core

    def climate_core(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        return torch.cat([out[:, :1] + 1.0, out[:, 1:]], dim=1)  # every tile 1 degree warmer

    mp.setattr(WorldPipeline, "_climate_core", climate_core)


def _wire_climate_altered(mp):
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    orig = WorldPipeline._compose_fused_core

    def core(self, *args, **kwargs):
        elev, climate = orig(self, *args, **kwargs)
        if climate is not None and climate.dtype == torch.float16:  # packed for the wire
            climate = torch.cat([climate[:, :2], climate[:, 2:3] * 1.01, climate[:, 3:]], dim=1)
        return elev, climate  # the served precipitation 1% high, the world's own unchanged

    mp.setattr(WorldPipeline, "_compose_fused_core", core)


@pytest.mark.parametrize("name", ["world90-f32.walk", "world90-bf16.walk"])
@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch_left_out, _answer_altered,
                                   _climate_altered, _wire_climate_altered])
def test_a_fault_under_the_timed_path_is_not_correct(fault, name, monkeypatch):
    fault(monkeypatch)
    line = _run(name)
    assert not line["correct"], line["checks"]
