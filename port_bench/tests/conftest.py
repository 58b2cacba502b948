"""Shared pieces of the benchmark's CPU tests: the harness on the path, one
torch thread, and a small world (the configuration's structure at tiny
widths, decoder tiles of 64) that runs a whole cell on the CPU in seconds."""
import copy
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


@pytest.fixture(autouse=True, scope="session")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(name: str = "world90-f32") -> dict:
    from harness import registry

    cfg = copy.deepcopy(registry.config(name))
    for stage, mc in cfg["models"].items():
        mc.update(model_channels=8, noise_emb_dims=8, logvar_channels=8)
        if stage == "coarse":
            mc["conditional_inputs"] = [["float", 8, 0.2]] * 5
        else:
            mc.update(model_channel_mults=[1, 2], layers_per_block=1)
        if stage == "base":
            mc.update(attn_resolutions=[32],
                      block_kwargs={"channels_per_head": 8, "attention_impl": "pallas"})
    cfg["models"]["decoder"]["image_size"] = 64
    cfg["world"].update(decoder_tile_size=64, decoder_tile_stride=48, latents_batch_size=[1, 2, 4])
    return cfg


def tiny_mix(cell: str) -> dict:
    """The cell's traffic mix with tiles of 32 pixels and 2 clients."""
    from harness import registry

    mix = copy.deepcopy(registry.traffic(registry.workload(cell)["traffic"]))
    mix.update(tile=32, clients=2)
    mix.update(warm_rows=1, width=4) if mix["pattern"] == "walk" else mix.update(warm=3)
    return mix
