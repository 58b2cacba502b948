"""Shared pieces of the port's data-parallel training tests: tiny configs of
the five trainers, an in-memory dataset made from a seed, the rank function
that ``parallel.distributed.launch`` runs in each gloo process, and the
comparison of two runs' files.

Importing this module registers the dataset, so a spawned rank that unpickles
``rank_run`` has it too.  Each rank pins one torch thread (``launch``) before
it builds a model.
"""
import json
import os

import numpy as np
import torch

from terrain_diffusion_tpu_torch.training.registry import build_registry, dataset_registry

TOL = dict(rtol=1e-5, atol=1e-5)  # data-parallel bar: N ranks against one process


class SeededItems:
    """``n_items`` deterministic items of one kind: "image" (size, size,
    channels) normals, or "climate" (a 4-vector and a label of 5 classes)."""

    def __init__(self, kind="image", n_items=16, size=16, channels=1, seed=0):
        self.kind, self.n, self.size, self.channels, self.seed = (kind, n_items, size,
                                                                  channels, seed)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng([self.seed, idx])
        if self.kind == "climate":
            x = rng.standard_normal(4).astype(np.float32)
            return {"image": x, "label": np.int64(int(x[0] > 0) + 2 * int(x[1] > 0))}
        return {"image": rng.standard_normal((self.size, self.size, self.channels))
                .astype(np.float32)}


dataset_registry.register("dp_seeded_items")(SeededItems)


def _unet(in_ch, out_ch, **kw):
    return {"@model": "unet", "image_size": 16, "in_channels": in_ch, "out_channels": out_ch,
            "model_channels": 8, "model_channel_mults": [1, 2], "layers_per_block": 1,
            "attn_resolutions": [], "midblock_attention": False, "fourier_scale": "pos",
            "noise_emb_dims": 8, "logvar_channels": 8, **kw}


def config(kind: str, save_dir: str, batch_size: int = 4) -> dict:
    """A tiny config of trainer ``kind`` ("diffusion", "dropout" = diffusion
    with block dropout 0.2, "consistency", "autoencoder", "gan",
    "perceptron")."""
    cfg = {
        "logging": {"save_dir": save_dir, "save_epochs": 0},
        "training": {"batch_size": batch_size, "epochs": 1, "epoch_steps": 8, "seed": 5,
                     "gradient_clip_val": 1.0},
        "ema": {"sigma_rels": [0.05, 0.1], "checkpoint_every_num_steps": 2},
        "lr_sched": {"@lr_sched": "constant", "lr": 3e-3},
        "train_dataset": {"@dataset": "dp_seeded_items"},
    }
    if kind in ("diffusion", "dropout"):
        cfg["trainer"] = {"@trainer": "diffusion"}
        cfg["model"] = _unet(1, 1, **({"block_kwargs": {"dropout": 0.2}}
                                      if kind == "dropout" else {}))
        cfg["training"].update(P_mean=-0.6, P_std=1.3)
    elif kind == "consistency":
        cfg["trainer"] = {"@trainer": "consistency"}
        cfg["model"] = _unet(1, 1, block_kwargs={"dropout": 0.1})
        cfg["training"].update(warmup_steps=4, P_mean=-0.6, P_std=1.6, sigma_data=0.5)
    elif kind == "autoencoder":
        cfg["trainer"] = {"@trainer": "autoencoder"}
        cfg["model"] = {"@model": "autoencoder", "image_size": 16, "in_channels": 1,
                        "latent_channels": 2, "model_channels": 8, "model_channel_mults": [1, 2],
                        "layers_per_block": 1, "attn_resolutions": [],
                        "midblock_attention": False, "logvar_channels": 8}
        cfg["training"].update(kl_weight=1e-3, perceptual="grad")
    elif kind == "gan":
        cfg["trainer"] = {"@trainer": "gan"}
        cfg["model"] = _unet(2, 1)
        cfg["discriminator"] = _unet(1, 1)
        cfg["training"].update(latent_channels=1, crop_size=12, mode="inject", r_gamma=0.1,
                               r_interval=2, burnin_steps=4, kl_weight=0.05,
                               disc_lr_mult=2.0, lr_warmup_factor=0.5)
        cfg["g_optimizer"] = {"kwargs": {"betas": [0.0, 0.99]}}
        cfg["d_optimizer"] = {"kwargs": {"betas": [0.5, 0.99]}}
    elif kind == "perceptron":
        cfg["trainer"] = {"@trainer": "perceptron"}
        cfg["model"] = {"@model": "perceptron", "in_dim": 4, "out_dim": 5,
                        "hidden_dims": [16, 12], "dropout": 0.2, "random_ensembles": 2}
        cfg["train_dataset"]["kind"] = "climate"
    else:
        raise ValueError(kind)
    return cfg


def train(cfg: dict, steps: int, world_size=None):
    from terrain_diffusion_tpu_torch.training.train import run_training

    build_registry()
    return run_training(cfg, max_steps=steps, log_every=1, device="cpu", world_size=world_size)


def rank_run(kind: str, save_dir: str, steps: int, batch_size: int = 4,
             rank_dirs: bool = False):
    """One rank of a run (inside ``launch``'s gloo group): rank r writes
    under ``save_dir/rank{r}`` with ``rank_dirs`` (only rank 0 may write),
    else under ``save_dir``.  Returns the rank's counters."""
    import torch.distributed as dist

    if rank_dirs:
        save_dir = os.path.join(save_dir, f"rank{dist.get_rank()}")
    return train(config(kind, save_dir, batch_size), steps)[2]


def rank_run_validating(save_dir: str, steps: int, sleep_s: float):
    """One rank of a diffusion run that validates after step 2, with the
    validation made ``sleep_s`` slower; rank r writes under
    ``save_dir/rank{r}``.  Returns (the rank's counters, the steps at which
    this rank ran the validation)."""
    import time

    import torch.distributed as dist

    from terrain_diffusion_tpu_torch.training.trainers.diffusion import DiffusionTrainer

    evaluated, real = [], DiffusionTrainer.evaluate_full

    def slow(self, state, val_dataset, generator, key=None):
        out = real(self, state, val_dataset, generator, key)
        time.sleep(sleep_s)
        evaluated.append(len(evaluated))
        return out

    DiffusionTrainer.evaluate_full = slow
    cfg = config("diffusion", os.path.join(save_dir, f"rank{dist.get_rank()}"))
    cfg["training"]["epoch_steps"] = 2
    cfg["evaluation"] = {"validate_epochs": 1, "validation_steps": 4, "kid_batch_size": 2}
    cfg["val_dataset"] = {"@dataset": "dp_seeded_items", "seed": 1}
    return train(cfg, steps)[2], len(evaluated)


def run_files(save_dir: str) -> dict:
    """What a run left in ``save_dir``: the weights, the optimizer and EMA
    state and counters (and a GAN's discriminator), and the metrics lines
    without their wall times."""
    from safetensors.torch import load_file

    ckpt = os.path.join(save_dir, "latest_checkpoint")
    out = {"model": load_file(os.path.join(ckpt, "saved_model", "model.safetensors")),
           "state": torch.load(os.path.join(ckpt, "train_state.pt"), map_location="cpu")}
    gan = os.path.join(ckpt, "gan_state.pt")
    if os.path.exists(gan):
        out["gan"] = torch.load(gan, map_location="cpu")
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        out["metrics"] = [{k: v for k, v in json.loads(ln).items() if k != "step_ms"}
                          for ln in f]
    return out


def assert_close(a, b, path="run"):
    """Equal structure; tensors and floats within TOL, the rest equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **TOL, err_msg=path)
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, **TOL, err_msg=path)
    else:
        assert a == b, path


def spatial_rank(config: dict, state: dict, x, noise_labels):
    """One rank of the row-sharded forward (inside ``launch``'s group):
    ``spatial_model`` of the U-Net ``config`` with weights ``state`` on
    this rank's band of ``x``; returns (the bands gathered, this rank's
    band), or the ``ValueError``'s message."""
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
    from terrain_diffusion_tpu_torch.parallel import make_mesh, shard_spatial, spatial_model
    from terrain_diffusion_tpu_torch.parallel.spatial import gather_bands

    model = EDMUnet2D(EDMUnetConfig.from_dict(config), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    sp = spatial_model(model.eval())
    try:
        with torch.no_grad():
            band = sp(shard_spatial(make_mesh(), x, dim=1), noise_labels, [])
    except ValueError as e:  # an uneven height: the rule's message
        return str(e)
    return gather_bands(band), band
