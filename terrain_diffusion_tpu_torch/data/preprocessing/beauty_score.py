"""Beauty score (counterpart of
``terrain_diffusion_tpu.data.preprocessing.beauty_score``): an FFT
band-power heuristic gives each subchunk a 1-5 ``beauty_score`` attr, which
the stratified sampler of the latent datasets reads.

The Laplacian decode of a subchunk runs on ``device``
(``ops/laplacian.py``); the FFT features stay on the host, as in JAX.
"""
from __future__ import annotations

import click
import numpy as np
import torch

from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_decode

# linear model fit on manual labels
COEFFICIENTS = [0.551959, -1.774091, 3.117426, -1.835090,
                -1.996856, -0.053519, 0.488380]
INTERCEPT = 4.44


def analyze_terrain_frequency(heightmap: np.ndarray, bins: int):
    """Mean log-power of the FFT spectrum in radial distance bins."""
    fft = np.fft.fftshift(np.fft.fft2(heightmap))
    h, w = heightmap.shape
    y, x = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    dist = np.sqrt(x**2 + y**2)
    power = np.log(np.abs(fft) + 1e-12)
    edges = np.linspace(0, 1, bins + 1)
    centers = ((edges[:-1] + edges[1:]) / 2).tolist()
    powers = []
    for i in range(bins):
        mask = (dist >= edges[i]) & (dist < edges[i + 1])
        powers.append(float(power[mask].mean()) if mask.any() else 0.0)
    return centers, powers


def calculate_beauty_score(lowfreq: np.ndarray, residual: np.ndarray, *, device="cuda") -> float:
    res = torch.from_numpy(np.ascontiguousarray(residual, np.float32)).to(device)
    low = torch.from_numpy(np.ascontiguousarray(lowfreq, np.float32)).to(device)
    with torch.no_grad():
        decoded = laplacian_decode(res[None], low[None])[0].cpu().numpy()
    decoded = np.sign(decoded) * decoded**2
    if (decoded <= 0).mean() > 0.99:
        return 1.0
    decoded = np.where(decoded < 0, 0.0, decoded)
    _, powers = analyze_terrain_frequency(decoded, bins=4)
    std = float(decoded.std())
    features = powers + [np.log(std), 250 / std, np.sqrt(std)]
    score = sum(c * f for c, f in zip(COEFFICIENTS, features)) + INTERCEPT
    return float(score)


def score_dataset(h5_file: str, resolution: int | None = None,
                  manual_scores_csv: str | None = None, *, device="cuda") -> int:
    """Write ``beauty_score`` on every subchunk group; returns the count."""
    import csv

    import h5py

    manual = {}
    if manual_scores_csv:
        with open(manual_scores_csv) as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    manual[row[0]] = float(row[1])
    with h5py.File(h5_file, "a") as f:
        res_keys = [str(resolution)] if resolution else list(f.keys())
        count = 0
        for rk in res_keys:
            for cid in f[rk]:
                for sub in f[rk][cid]:
                    g = f[rk][cid][sub]
                    if "residual" not in g or "lowfreq" not in g:
                        continue
                    key = f"{rk}/{cid}/{sub}"
                    if key in manual:
                        score = manual[key]
                    else:
                        score = calculate_beauty_score(
                            np.asarray(g["lowfreq"], np.float32),
                            np.asarray(g["residual"], np.float32), device=device)
                    g.attrs["beauty_score"] = float(np.clip(score, 1.0, 5.0))
                    count += 1
        print(f"scored {count} subchunks")
    return count


@click.command()
@click.argument("dataset-file", type=click.Path(exists=True))
@click.option("--resolution", type=int, default=None)
@click.option("--manual-scores", default=None,
              help="CSV of manual labels (path,score) overriding the heuristic")
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def main(dataset_file, resolution, manual_scores, device):
    """Compute beauty scores for every subchunk of a dataset."""
    click_check_device(device)
    return score_dataset(dataset_file, resolution, manual_scores, device=device)


if __name__ == "__main__":
    main()
