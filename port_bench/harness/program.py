"""The system under test: the port's world behind its threaded ``/terrain`` API.

As ``python -m terrain_diffusion_tpu_torch.serving.api <world> --threaded
[--dtype bf16]`` serves it, but in this process: a ``WorldPipeline`` with the
configuration's settings over the benchmark's weights, bound to the default
in-memory direct store, wrapped by ``serving/api.py`` in a
``CoalescedPipeline`` and served by ``serving/httpd.py``'s threaded server
(handlers concurrent, one pipeline worker) on a loopback port picked here.
"""
from __future__ import annotations

import threading

import torch


def build_models(model_cfgs: dict, states: dict, device) -> dict:
    """The port's three ``EDMUnet2D`` modules, built on the meta device (no
    initialisation) and given the benchmark's weights."""
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig

    from harness.weights import STAGES, for_port

    out = {}
    for s in STAGES:
        with torch.device("meta"):
            m = EDMUnet2D(EDMUnetConfig.from_dict(model_cfgs[s]), device="meta",
                          generator=torch.Generator())
        m = m.to_empty(device=device)
        m.load_state_dict(for_port(states[s], model_cfgs[s]), strict=True)
        for p in m.parameters():
            p.requires_grad_(False)
        out[s] = m.eval()
    return out


class Server:
    """The port's world served on ``127.0.0.1:<port>``; ``world`` is the
    ``WorldPipeline``, ``pipeline`` the ``CoalescedPipeline`` the handlers
    call."""

    def __init__(self, models: dict, world_cfg: dict, world_seed: int, dtype, device):
        from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
        from terrain_diffusion_tpu_torch.serving import api

        self.world = WorldPipeline(seed=world_seed, dtype=dtype, device=device, **world_cfg)
        self.world.set_models(models["coarse"], models["base"], models["decoder"])
        api.configure(pipeline=self.world, coalesce=True)
        self.pipeline = api._get_pipeline()  # binds the store, wraps in the coalescer
        self.httpd = api.app.make_server("127.0.0.1", 0, quiet=True, threaded=True,
                                         serialize=False)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="httpd",
                                        daemon=True)
        self._thread.start()

    def stop_http(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=60)

    def close(self):
        """Stop the coalescer's worker and close the world."""
        from terrain_diffusion_tpu_torch.serving import api

        self.pipeline.close()
        api.configure()
        self.world = self.pipeline = None
