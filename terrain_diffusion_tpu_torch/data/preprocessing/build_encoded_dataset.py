"""build-encoded-dataset (counterpart of
``terrain_diffusion_tpu.data.preprocessing.build_encoded_dataset``): runs
the trained VAE's encoder over every subchunk's residual with 8-fold D4
augmentation and stores ``latent[8, 2C, h, w]`` in fp16, with per-channel
latent statistics (Welford).

``encode_residual`` is the per-subchunk work: on a CUDA model, a 1024x1024
subchunk (the defaults' 4096 / 4 chunks) is one float32 encode of
8 x 1024 x 1024 x 1 through the fused-block and 3x3-conv kernels.  The HDF5
loop needs ``h5py``.
"""
from __future__ import annotations

import click
import numpy as np
import torch
from tqdm import tqdm

from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
from terrain_diffusion_tpu_torch.data.welford import Welford
from terrain_diffusion_tpu_torch.nn import torch_compat


def _d4_stack(arr: np.ndarray) -> np.ndarray:
    """(H, W) -> (8, H, W): 4 rotations x [identity, horizontal flip]."""
    out = []
    for flip in (False, True):
        a = arr[:, ::-1] if flip else arr
        for k in range(4):
            out.append(np.ascontiguousarray(np.rot90(a, k)))
    return np.stack(out)


def encode_residual(ae, residual: np.ndarray, *, sigma_data: float = 0.5,
                    residual_mean: float = 0.0, residual_std: float = 1.1678) -> np.ndarray:
    """(H, W) residual -> (8, 2C, h, w) float32: the means and logvars of its
    eight D4 views, normalised as the training data, encoded on the model's
    device without autograd (the kernels define no backward)."""
    x = (np.asarray(residual, np.float32) - residual_mean) / residual_std * sigma_data
    stack = torch.from_numpy(_d4_stack(x)[..., None])  # (8, H, W, 1)
    device = next(ae.parameters()).device
    with torch.no_grad():
        means, logvars = ae.preencode(stack.to(device))
        enc = torch.cat([means, logvars], dim=-1).permute(0, 3, 1, 2)
    return enc.float().cpu().numpy()


def build_encoded_dataset(h5_file: str, model_path: str, resolution: int = 90,
                          sigma_data: float = 0.5, residual_mean: float = 0.0,
                          residual_std: float = 1.1678, *, device="cuda"):
    import h5py

    ae = torch_compat.load_model(model_path, device=device)
    lc = ae.config.latent_channels
    stats = Welford(lc)
    with h5py.File(h5_file, "a") as f:
        res_group = f[str(resolution)]
        jobs = [(chunk_id, sub_id) for chunk_id in res_group for sub_id in res_group[chunk_id]
                if "residual" in res_group[chunk_id][sub_id]
                and "latent" not in res_group[chunk_id][sub_id]]
        print(f"{len(jobs)} subchunks to encode")
        for chunk_id, sub_id in tqdm(jobs):
            g = res_group[chunk_id][sub_id]
            enc = encode_residual(ae, np.asarray(g["residual"], np.float32),
                                  sigma_data=sigma_data, residual_mean=residual_mean,
                                  residual_std=residual_std)
            d = g.create_dataset("latent", data=enc.astype(np.float16), compression="lzf")
            d.attrs["pct_land"] = g["residual"].attrs["pct_land"]
            d.attrs["split"] = g["residual"].attrs.get("split", "train")
            # only the identity view's means feed the stats
            stats.update(enc[0, :lc])
        # a resumed run saw only the new subchunks: keep the stored stats
        if not stats.count.any():
            print("no new subchunks: keeping the existing stats attrs")
        elif "latents_mean" in res_group.attrs:
            print("resume: new latents NOT folded into the stored stats "
                  "attrs; delete the attrs to recompute from a full rerun")
        else:
            res_group.attrs["latents_mean"] = stats.mean.tolist()
            res_group.attrs["latents_std"] = stats.std.tolist()
    if stats.count.any():
        print(f"latent stats: mean={stats.mean} std={stats.std}")


@click.command("build-encoded-dataset")
@click.argument("h5_file", type=click.Path(exists=True))
@click.argument("model_path", type=click.Path(exists=True))
@click.option("--resolution", type=int, default=90)
@click.option("--sigma-data", type=float, default=0.5)
@click.option("--residual-mean", type=float, default=0.0)
@click.option("--residual-std", type=float, default=1.1678)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def main(h5_file, model_path, resolution, sigma_data, residual_mean, residual_std, device):
    """Encode dataset residuals with a trained VAE (8-fold pre-augmentation)."""
    click_check_device(device)
    build_encoded_dataset(h5_file, model_path, resolution, sigma_data,
                          residual_mean, residual_std, device=device)


if __name__ == "__main__":
    main()
