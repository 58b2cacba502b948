"""The port's entry points run on the card unless the caller asks for the
CPU, and fail loudly, before any model is loaded, when there is no card."""
import pytest
import torch

from terrain_diffusion_tpu_torch.pipeline import world
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.serving import api
from terrain_diffusion_tpu_torch.serving import minecraft_api as mc

SERVERS = pytest.mark.parametrize("server", [api, mc], ids=["api", "minecraft_api"])


def test_world_pipeline_defaults_to_the_card():
    # __init__ allocates nothing, so this holds on a machine without a card
    assert WorldPipeline(seed=1).device.type == "cuda"
    assert WorldPipeline(seed=1, device="cpu").device.type == "cpu"


@SERVERS
def test_main_without_a_card_exits_naming_device_cpu(server, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_loading(*a, **k):
        raise AssertionError("a model was loaded")

    monkeypatch.setattr(WorldPipeline, "from_pretrained", no_loading)
    with pytest.raises(SystemExit) as exc:
        server.main([str(tmp_path / "no_world_here"), "--port", "0"])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in capsys.readouterr().err
    server.configure()


@SERVERS
def test_configured_loader_defaults_to_the_card(server, monkeypatch):
    seen = {}

    class Loaded(Exception):
        pass

    def record(path, **kw):
        seen.update(kw, path=path)
        raise Loaded

    monkeypatch.setattr(world.WorldPipeline, "from_pretrained", record)
    server.configure(model_path="some_world")
    with pytest.raises(Loaded):
        server._get_pipeline()
    server.configure()
    assert seen["path"] == "some_world" and seen["device"] == "cuda"
