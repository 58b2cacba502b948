"""World kinds: the default ``t2`` gives the weights, windows, work counts and
reference tiles that the harness gave before kinds existed, and a kind added
as a file alone (a fourth model, a world attribute for it, a stage list of
its own) runs a whole cell on the CPU."""
import copy
import hashlib
import math
import os
import shutil
import time

import pytest
import torch

from conftest import BENCH_DIR, tiny_config, tiny_mix
from harness import check, registry, weights

BOXES = [(0, 0, 256, 256), (256, 0, 512, 256), (0, 256, 256, 512),
         (49152, -98304, 49408, -98048), (-7, 13, 25, 45)]


def _frozen_make(model_cfgs: dict, seed: int, device) -> dict:
    """``harness/weights.py::make`` as it was before world kinds, frozen."""
    stages = ("coarse", "base", "decoder")
    shapes = {s: weights._shapes(model_cfgs[s]) for s in stages}
    normal = [(s, k, sh) for s in stages for k, sh in shapes[s].items()
              if not k.endswith("phases")]
    uniform = [(s, k, sh) for s in stages for k, sh in shapes[s].items()
               if k.endswith("phases")]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    n_total = sum(math.prod(sh) for _, _, sh in normal)
    u_total = sum(math.prod(sh) for _, _, sh in uniform)
    draws = {"n": torch.randn(n_total, generator=g, device=device),
             "u": torch.rand(u_total, generator=g, device=device)}
    out = {s: {} for s in stages}
    for kind, entries in (("n", normal), ("u", uniform)):
        off = 0
        for s, k, sh in entries:
            n = math.prod(sh)
            out[s][k] = draws[kind][off:off + n].reshape(sh)
            off += n
    for s in stages:
        for k, t in out[s].items():
            if k.endswith("emb_gain"):
                out[s][k] = t * 0.5
            elif k == "out_gain":
                out[s][k] = torch.ones_like(t)
            elif k.endswith("freqs") or k.endswith("phases"):
                out[s][k] = t * (2 * math.pi)
    return out


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 63 + 99])
def test_t2_draws_the_weights_bit_for_bit_as_before(seed):
    cfg = tiny_config()
    kind = registry.world_kind(cfg)
    got = weights.make(cfg["models"], seed, "cpu", kind.MODELS)
    want = _frozen_make(cfg["models"], seed, "cpu")
    assert list(got) == list(want) == ["coarse", "base", "decoder"]
    for s in want:
        assert list(got[s]) == list(want[s])
        for k in want[s]:
            assert torch.equal(got[s][k], want[s][k]), (s, k)


# the windows and FLOPs a window of the harness before world kinds, for BOXES
# (a count and the first 16 hex digits of sha256(repr(sorted(windows)))
FROZEN = {
    "world90-f32": (
        {"coarse": (8, "f4f81293b3da28eb"), "latent_init": (126, "3f8d10f672eb76b8"),
         "latent_step": (70, "7951d263e6b1012a"), "decoder": (12, "d10ce7c0e9711846")},
        {"coarse": 430209761280.0, "latent_init": 193621131264.0,
         "latent_step": 193621131264.0, "decoder": 1375631048704.0}),
    "tiny": (
        {"coarse": (8, "f4f81293b3da28eb"), "latent_init": (84, "c523cdae44dcd254"),
         "latent_step": (40, "a17b6835f6db9708"), "decoder": (252, "b60ef911cb6696af")},
        {"coarse": 1879572480.0, "latent_init": 217251840.0, "latent_step": 217251840.0,
         "decoder": 145686528.0}),
}


@pytest.mark.parametrize("name", ["world90-f32", "world90-bf16", "tiny"])
def test_t2_windows_and_work_equal_the_frozen_ones(name):
    cfg = tiny_config() if name == "tiny" else registry.config(name)
    kind = registry.world_kind(cfg)
    assert kind.MODEL_STAGES == ("coarse", "latent_init", "latent_step", "decoder")
    want_windows, want_flops = FROZEN["tiny" if name == "tiny" else "world90-f32"]
    got = kind.windows(cfg["world"], BOXES)
    assert {k: (len(v), hashlib.sha256(repr(sorted(v)).encode()).hexdigest()[:16])
            for k, v in got.items()} == want_windows
    assert kind.window_flops(cfg["models"], cfg["world"]) == want_flops


def test_t2_reference_tiles_are_the_reference_worlds():
    from reference.unet import UNet
    from reference.world import RefWorld

    cfg = tiny_config()
    kind = registry.world_kind(cfg)
    states = weights.make(cfg["models"], 2 ** 31 + 1, "cpu", kind.MODELS)
    boxes = [(0, 0, 32, 32), (96, -64, 128, -32)]
    got = check.reference_tiles(kind, cfg["models"], states, cfg["world"], 77, boxes, "cpu")
    models = {}
    for s, mc in cfg["models"].items():
        models[s] = UNet(mc, device="cpu")
        models[s].load_state_dict(states[s])
    ref = RefWorld(models["coarse"], models["base"], models["decoder"], 77, cfg["world"], "cpu")
    with torch.no_grad():
        for g, box in zip(got, boxes):
            want = ref.tile(*box)
            want["wire_elev"] = want["wire_elev"].float()
            want["climate"] = want["climate"][:4]
            assert g.keys() == want.keys()
            for k in want:
                assert torch.equal(g[k], want[k]), (box, k)


def test_an_unknown_world_kind_names_its_missing_file():
    with pytest.raises(FileNotFoundError, match=r"worlds[/\\]nowhere\.py"):
        registry.world_kind({"world_kind": "nowhere", "models": {}})


# A world kind written as a file: the t2 world whose latent model is a guided
# pair, the output of the main model m and of a guide g on the same input
# combined as g + s (m - g).  The guide is a fourth model with a world
# attribute of its own; the kind lists its model stages in an order of its own.
TOY_KIND = '''
import os

import torch

from harness import registry
from harness.work import unet_forward_flops
from reference.world import LATENT_TILE

T2 = registry.world_kind({}, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODELS = {"coarse": "coarse_model", "base": "guided_main", "guide": "guide_model",
          "decoder": "decoder_model"}
MODEL_STAGES = ("latent_init", "latent_step", "decoder", "coarse")
SCALE = 1.5


class Guided(torch.nn.Module):
    def __init__(self, main, guide):
        super().__init__()
        self.main, self.guide = main, guide

    def forward(self, x, noise_labels, cond, **kw):
        g = self.guide(x, noise_labels, cond, **kw)
        return g + SCALE * (self.main(x, noise_labels, cond, **kw) - g)


def attach(world, models):
    world.set_models(models["coarse"], Guided(models["base"], models["guide"]),
                     models["decoder"])
    world.guided_main, world.guide_model = world.base_model.main, world.base_model.guide


def reference(models, seed, world_cfg, device):
    return T2.reference(dict(models, base=Guided(models["base"], models["guide"])), seed,
                        world_cfg, device)


windows = T2.windows


def window_flops(model_cfgs, world_cfg):
    out = T2.window_flops(model_cfgs, world_cfg)
    guide = unet_forward_flops(model_cfgs["guide"], 1, LATENT_TILE)
    return dict(out, latent_init=out["latent_init"] + guide,
                latent_step=out["latent_step"] + guide)
'''


def test_a_world_kind_added_as_a_file_runs_a_cell(tmp_path, capfd):
    from harness.cell import run_cell

    bench_dir = tmp_path / "port_bench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "worlds" / "toy.py").write_text(TOY_KIND)
    cfg = tiny_config()
    cfg["world_kind"] = "toy"
    cfg["models"]["guide"] = dict(copy.deepcopy(cfg["models"]["base"]), model_channels=4)
    bench = registry.benchmark()
    bench = dict(bench, workloads=bench["workloads"] + [
        {"name": "toy.walk", "config": "toy", "traffic": "walk", "chips": 1, "why": "a test"}])
    workload = dict(registry.workload("world90-f32.walk"), config="toy")
    line = run_cell("toy.walk", 2 ** 31 + 23, 5.0, True, t_process=time.perf_counter(),
                    device="cpu", config=cfg, workload=workload, bench=bench,
                    mix=tiny_mix("world90-f32.walk"), bench_dir=str(bench_dir))
    err = capfd.readouterr().err
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert {"stage_ms_per_tile.models", "mfu"} <= set(line["metrics"])
    stages = next(ln for ln in err.splitlines() if "[trace] stage ms per tile:" in ln)
    assert [p.split()[0] for p in stages.split(": ", 1)[1].split(", ")] == [
        "latent_init", "latent_step", "decoder", "coarse", "compose", "fetch", "prefetch"]
    rows = next(ln for ln in err.splitlines() if "rows the models ran:" in ln)
    ran = dict(p.split() for p in rows.split("rows the models ran: ")[1].split(";")[0].split(", "))
    assert int(ran["guide"]) > 0 and ran["guide"] == ran["base"]
    assert not os.path.exists(os.path.join(BENCH_DIR, "worlds", "toy.py"))
