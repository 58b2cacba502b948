"""Distribution metrics: FID (Frechet) and KID (polynomial-kernel MMD).

Counterpart of ``terrain_diffusion_tpu.evaluation.metrics``.  The default
feature extractor, ``terrain_features``, computes multi-scale structural
statistics of heightmaps (pooled heights, gradients, a Laplacian band) as
tensor ops on the tensor's device; FID and KID themselves run in numpy /
scipy in float64, as in the JAX package.  ``resolve_feature_fn("inception:<weights>")``
gives InceptionV3 pool3 features (``evaluation/inception.py``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from terrain_diffusion_tpu_torch.ops.image import avg_pool


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row quantile with linear interpolation (numpy's and JAX's
    default); by sorting, as ``torch.quantile`` limits its input size."""
    s = torch.sort(flat, dim=1).values
    pos = q * (s.shape[1] - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, s.shape[1] - 1)
    frac = pos - lo
    return s[:, lo] + (s[:, hi] - s[:, lo]) * frac


def terrain_features(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) heightmaps -> (B, D) structural feature vectors."""
    x = torch.as_tensor(x).float()
    if x.dim() == 3:
        x = x[..., None]
    feats = []
    xc = x.permute(0, 3, 1, 2)  # (B, C, H, W)
    for scale in (1, 2, 4, 8):
        if min(x.shape[1], x.shape[2]) // scale < 3:
            continue  # pooled map too small for gradients / the Laplacian
        xs = avg_pool(xc, scale) if scale > 1 else xc
        gx = torch.diff(xs, dim=-1)
        gy = torch.diff(xs, dim=-2)
        lap = (xs[..., 1:-1, 1:-1] * 4 - xs[..., :-2, 1:-1] - xs[..., 2:, 1:-1]
               - xs[..., 1:-1, :-2] - xs[..., 1:-1, 2:])
        for t in (xs, gx, gy, lap):
            flat = t.reshape(t.shape[0], -1)
            feats += [flat.mean(1), flat.std(1, correction=0), flat.abs().mean(1),
                      _quantile(flat, 0.05), _quantile(flat, 0.95)]
    b = x.shape[0]
    h16 = avg_pool(xc, max(x.shape[1] // 4, 1)).reshape(b, -1)  # coarse 4x4 layout
    return torch.cat([torch.stack(feats, dim=1), h16], dim=1)


def resolve_feature_fn(spec) -> Callable:
    """A feature-extractor spec as a callable: a callable as it is, None or
    "terrain" as ``terrain_features``, "inception:/path/to/weights" (or
    "inception" with the path in ``$TDTPU_INCEPTION_WEIGHTS``) as InceptionV3
    pool3 features."""
    import os

    if callable(spec):
        return spec
    if spec in (None, "terrain"):
        return terrain_features
    if isinstance(spec, str) and spec.startswith("inception"):
        from terrain_diffusion_tpu_torch.evaluation.inception import inception_feature_fn

        path = spec.split(":", 1)[1] if ":" in spec else os.environ.get(
            "TDTPU_INCEPTION_WEIGHTS", "")
        if not path:
            raise ValueError("inception features need a weights file: pass "
                             "'inception:/path/to/pt_inception.pth' or set "
                             "$TDTPU_INCEPTION_WEIGHTS (weights are not bundled)")
        return inception_feature_fn(path)
    raise ValueError(f"unknown feature extractor {spec!r}")


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two feature sets (Frechet distance of fitted Gaussians)."""
    import scipy.linalg

    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    # sqrtm's one return value (newer scipy dropped disp=False, which also
    # returned an error estimate); the same root either way
    covmean = scipy.linalg.sqrtm(cov_a @ cov_b)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov_a + cov_b - 2 * covmean))


def kid(feats_a: np.ndarray, feats_b: np.ndarray, n_subsets: int = 100,
        subset_size: int | None = None, seed: int = 0) -> tuple[float, float]:
    """KID mean / std: unbiased MMD^2 with the polynomial kernel
    k(x, y) = (x.y / d + 1)^3 over random subsets, on features standardized
    per dimension by the pooled (a + b) statistics, in float64 (the JAX
    package's estimator; its docstring gives the reasons)."""
    rng = np.random.default_rng(seed)
    pooled = np.concatenate([feats_a, feats_b]).astype(np.float64)
    mu = pooled.mean(0)
    sd = np.maximum(pooled.std(0), 1e-8)
    feats_a = (np.asarray(feats_a, np.float64) - mu) / sd
    feats_b = (np.asarray(feats_b, np.float64) - mu) / sd
    n = min(len(feats_a), len(feats_b))
    m = subset_size or min(max(n // 2, 1), 1000)
    d = feats_a.shape[1]

    def poly(x, y):
        return (x @ y.T / d + 1.0) ** 3

    vals = []
    for _ in range(n_subsets):
        ia = rng.choice(len(feats_a), m, replace=False)
        ib = rng.choice(len(feats_b), m, replace=False)
        x, y = feats_a[ia], feats_b[ib]
        k_xx, k_yy, k_xy = poly(x, x), poly(y, y), poly(x, y)
        np.fill_diagonal(k_xx, 0)
        np.fill_diagonal(k_yy, 0)
        vals.append(k_xx.sum() / (m * (m - 1)) + k_yy.sum() / (m * (m - 1))
                    - 2 * k_xy.mean())
    return float(np.mean(vals)), float(np.std(vals))


def normalize_terrain_for_metric(terrain: np.ndarray) -> np.ndarray:
    """Per-image [0, 255] normalization (reference
    ``_normalize_and_process_terrain``)."""
    t = np.asarray(terrain, np.float32)
    tmin = t.min(axis=(1, 2, 3), keepdims=True)
    tmax = t.max(axis=(1, 2, 3), keepdims=True)
    trange = np.maximum(tmax - tmin, 255.0)
    tmid = (tmin + tmax) / 2
    return np.clip(((t - tmid) / trange + 0.5) * 255, 0, 255)


@torch.no_grad()
def extract_features(xs: np.ndarray, feature_fn: Callable = terrain_features,
                     batch: int = 64, device="cuda") -> np.ndarray:
    """Features of ``xs`` in batches, computed on ``device``."""
    out = []
    for i in range(0, len(xs), batch):
        chunk = torch.from_numpy(np.ascontiguousarray(xs[i:i + batch], np.float32))
        out.append(feature_fn(chunk.to(device)).cpu().numpy())
    return np.concatenate(out)


def compute_kid(real: np.ndarray, fake: np.ndarray, feature_fn: Callable = terrain_features,
                batch: int = 64, device="cuda", **kid_kwargs) -> tuple[float, float]:
    """KID between two image sets (any comparable normalization)."""
    return kid(extract_features(real, feature_fn, batch, device),
               extract_features(fake, feature_fn, batch, device), **kid_kwargs)


def compute_fid(real: np.ndarray, fake: np.ndarray, feature_fn: Callable = terrain_features,
                batch: int = 64, device="cuda") -> float:
    return frechet_distance(extract_features(real, feature_fn, batch, device),
                            extract_features(fake, feature_fn, batch, device))


def compute_fid_kid(real: np.ndarray, fake: np.ndarray, feature_fn: Callable = terrain_features,
                    batch: int = 64, device="cuda", **kid_kwargs):
    """(fid, kid_mean, kid_std), with the features of each set extracted once."""
    fa = extract_features(real, feature_fn, batch, device)
    fb = extract_features(fake, feature_fn, batch, device)
    kid_mean, kid_std = kid(fa, fb, **kid_kwargs)
    return frechet_distance(fa, fb), kid_mean, kid_std
