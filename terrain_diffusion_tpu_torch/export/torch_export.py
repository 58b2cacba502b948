"""Ahead-of-time programs of the pipeline's U-Nets: ``torch.export``.

Counterpart of ``terrain_diffusion_tpu.export.stablehlo_export``, which
serializes each U-Net's forward with ``jax.export``.  Here each forward is
traced by ``torch.export`` and written with ``torch.export.save`` as a
``.pt2`` program, with a JSON manifest of its input shapes.  The inputs
are NHWC, as in JAX: ``x`` (batch, spatial, spatial, in_channels), the
noise labels (batch,) and one float32 tensor per conditional input.

The hand-written kernels are PyTorch operators (``ops/cuda_lib.py``), so a
program traced from a model whose blocks take them holds
``tdt::fused_block``, ``tdt::conv3x3`` and ``tdt::pixelnorm_attention`` as
nodes: run on a CUDA tensor, the loaded program launches the kernels;
on a CPU tensor it runs their plain versions, as eager does.  Those
operators exist only once this package is imported (its ``__init__``
registers them), so ``torch.export.load`` reads a program where
``terrain_diffusion_tpu_torch`` is imported.  The trace runs with
gradients off, as inference does (a forward autograd records through
takes the plain path), and the program's weights need no gradient.
"""
from __future__ import annotations

import json
import os
import time

import click
import numpy as np
import torch
from torch import nn


class UNetForward(nn.Module):
    """A U-Net's inference forward with the conditional inputs as
    positional arguments: ``(x, noise_labels, *cond) -> output``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, noise_labels, *cond):
        return self.model(x, noise_labels, list(cond))


def export_unet(model, batch_size: int, spatial: int, in_channels: int, cond_specs,
                out_path: str, verify: bool = True) -> dict:
    """Write one U-Net forward as a ``torch.export`` program; returns its
    manifest entry (``path``, ``inputs``, ``bytes``, ``export_s`` and, with
    ``verify``, ``max_abs_diff`` and ``verified``).

    The program traces on the model's device.  With ``verify`` it is loaded
    back and run on inputs from a numpy seed against the eager forward,
    within JAX's rtol / atol of 1e-5 (the same operators run, so the two
    agree bit for bit); the file lands at ``out_path`` only after that."""
    dev = next(model.parameters()).device
    shapes = [(batch_size, spatial, spatial, in_channels), (batch_size,),
              *(tuple(spec) for spec in cond_specs)]
    fn = UNetForward(model).eval()
    root, ext = os.path.splitext(out_path)
    tmp_path = root + ".tmp" + ext  # torch.export.save wants the .pt2 suffix
    grads = [p.requires_grad for p in model.parameters()]
    t0 = time.perf_counter()
    try:
        model.requires_grad_(False)
        with torch.no_grad():
            program = torch.export.export(
                fn, tuple(torch.zeros(s, device=dev) for s in shapes))
        torch.export.save(program, tmp_path)
    finally:
        for p, g in zip(model.parameters(), grads):
            p.requires_grad_(g)
    entry = {"path": os.path.basename(out_path), "inputs": [list(s) for s in shapes],
             "bytes": os.path.getsize(tmp_path), "export_s": time.perf_counter() - t0}
    try:
        if verify:
            rng = np.random.default_rng(0)
            args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                    for s in shapes]
            with torch.no_grad():
                want = fn(*args)
                got = torch.export.load(tmp_path).module()(*args)
            entry["max_abs_diff"] = float((got - want).abs().max())
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
            entry["verified"] = True
    except BaseException:
        os.remove(tmp_path)
        raise
    os.replace(tmp_path, out_path)
    return entry


@click.command("export")
@click.argument("model_path")
@click.argument("out_dir", type=click.Path())
@click.option("--batch-size", type=int, default=1, show_default=True)
@click.option("--decoder-tile", type=int, default=512, show_default=True)
@click.option("--verify/--no-verify", default=True, show_default=True,
              help="Load each program back and hold it to the eager forward.")
@click.option("--device", default="cuda", show_default=True,
              help="where the programs trace and run; --device cpu runs on the CPU")
def main(model_path, out_dir, batch_size, decoder_tile, verify, device):
    """Export the pipeline's three U-Nets as torch.export programs (.pt2).

    MODEL_PATH is a pipeline directory with coarse_model/ base_model/
    decoder_model/ subfolders.  The programs call this package's kernel
    operators: load one with ``torch.export.load`` after ``import
    terrain_diffusion_tpu_torch``.  Returns the manifest.
    """
    from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
    from terrain_diffusion_tpu_torch.nn import torch_compat

    click_check_device(device)
    os.makedirs(out_dir, exist_ok=True)
    manifest = {}
    specs = {  # each pipeline U-Net's inputs, as JAX's export gives them
        "coarse_model": dict(spatial=64, in_channels=11, cond=[(batch_size,)] * 5),
        "base_model": dict(spatial=64, in_channels=5, cond=[(batch_size, 58)]),
        "decoder_model": dict(spatial=decoder_tile, in_channels=5, cond=[]),
    }
    for name, spec in specs.items():
        sub = os.path.join(model_path, name)
        if not os.path.isdir(sub):
            click.echo(f"skipping {name} (not found)")
            continue
        model = torch_compat.load_model(sub, device=device)
        out_path = os.path.join(out_dir, f"{name}.pt2")
        manifest[name] = export_unet(model, batch_size, spec["spatial"], spec["in_channels"],
                                     spec["cond"], out_path, verify=verify)
        click.echo(f"exported {name} -> {out_path}")
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    click.echo(f"manifest written to {out_dir}/manifest.json")
    return manifest


if __name__ == "__main__":
    main()
