"""Config-driven training entry point (counterpart of
``terrain_diffusion_tpu/training/train.py``).

``python -m terrain_diffusion_tpu_torch.training.train --config cfg.cfg
[-o key.path=value ...] [--device cuda|cpu]``

The step's random numbers come from a generator that is a pure function of
(seed, step) (``step_generator``; JAX: ``jax.random.fold_in(key, step)``),
so a resumed run replays the noise an uninterrupted run would draw.  On the
card float32 runs at full precision (TF32 off, ``use_full_f32``).  Metrics
stream to stdout and ``save_dir/metrics.jsonl``, one line per ``log_every``
steps with the mean of each metric, ``step_ms`` among them: the wall time
of a step, whose metrics are read back, so its device work is inside it.
Checkpoints go to ``save_dir/latest_checkpoint/`` (``trainers/base.py``),
EMA snapshots to ``save_dir/phema/``.

Data parallelism, as JAX trains on every local device: the ``train``
command on ``cuda`` (no index) with more than one visible card starts one
process per card (``CUDA_VISIBLE_DEVICES`` chooses fewer) over NCCL; the
library's ``run_training(world_size=N)`` starts N processes on any device
(gloo on the CPU) and otherwise trains in the calling process.
Inside a process group (its own, or one the caller made) every rank reads
the same global batch from the same seeded iterator and trains on its rows
(``trainers/base.py::shard``); the gradients are averaged over the ranks
(``diffusion_core.gradients``), so every rank's parameters, Adam moments
and EMA stay the same.  Logged metrics are the mean over the ranks (the
max for ``max_*``).  Rank 0 alone writes ``metrics.jsonl``, the checkpoints
and the ``phema/`` snapshots; every rank resumes from the same checkpoint.
Every rank runs the validation (the same data and draws, so the same
result; rank 0 logs it): a rank that went on alone would wait in the next
step's all-reduce as long as the validation lasts, past the group's
timeout on a long one.
"""
from __future__ import annotations

import json
import os
import time

import click
import numpy as np
import torch

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.parallel import distributed, make_mesh
from terrain_diffusion_tpu_torch.parallel.mesh import in_process_group
from terrain_diffusion_tpu_torch.training.registry import (apply_overrides, build_registry,
                                                           load_config, resolve)

INIT_STREAM, STEP_STREAM = 0, 1


def stream_generator(seed: int, *path: int) -> torch.Generator:
    """A CPU generator seeded by (seed, *path) through numpy's SeedSequence."""
    state = np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def step_generator(seed: int, step: int) -> torch.Generator:
    return stream_generator(seed, STEP_STREAM, step)


def _train_rank(config, ckpt_path, max_steps, log_every, device):
    """One rank of ``run_training``'s processes: its counters."""
    return run_training(config, ckpt_path, max_steps, log_every, device)[2]


def run_training(config: dict, ckpt_path: str | None = None, max_steps: int | None = None,
                 log_every: int = 32, device="cuda", world_size: int | None = None):
    """Train per ``config`` (a parsed .cfg) to ``max_steps`` or its epochs;
    resumes from ``ckpt_path`` or ``save_dir/latest_checkpoint``.  Returns
    (trainer, state, counters).

    With ``world_size`` above 1 (and outside a process group), this
    process starts that many ranks to train data-parallel and returns
    (None, None, rank 0's counters): the trained state is in the checkpoint
    rank 0 wrote.  Otherwise it trains here, as a rank of the caller's
    process group where there is one."""
    log_every = max(1, int(log_every))
    device = torch.device(device)
    if not in_process_group() and world_size is not None and world_size > 1:
        backend = "nccl" if device.type == "cuda" else "gloo"
        counters = distributed.launch(_train_rank, world_size, config, ckpt_path, max_steps,
                                      log_every, str(device), backend=backend)[0]
        return None, None, counters
    mesh = make_mesh() if in_process_group() else None
    rank0 = mesh is None or mesh.rank == 0
    if mesh is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        use_full_f32()
    build_registry()
    resolved = resolve(config)
    trainer = resolved["trainer"](config, resolved, device=device)
    trainer.mesh = mesh

    logging_cfg = config.get("logging", {})
    save_dir = logging_cfg.get("save_dir", "checkpoints/run")
    if rank0:
        os.makedirs(save_dir, exist_ok=True)

    tr = config.get("training", {})
    seed = int(tr.get("seed", 0))
    batch_size = int(tr.get("batch_size", 8))
    epochs = int(tr.get("epochs", 1))
    epoch_steps = int(tr.get("epoch_steps", 64))
    save_epochs = int(logging_cfg.get("save_epochs", 1))

    state = trainer.init_state(stream_generator(seed, INIT_STREAM),
                               save_dir=save_dir if rank0 else None)
    counters = {"epoch": 0, "step": 0, "seen": 0}
    ckpt_dir = os.path.join(save_dir, "latest_checkpoint")
    if ckpt_path:
        counters = trainer.load_checkpoint(state, ckpt_path)
        print(f"Resumed from {ckpt_path} at step {counters['step']}")
    elif os.path.exists(os.path.join(ckpt_dir, "train_state.pt")):
        counters = trainer.load_checkpoint(state, ckpt_dir)
        print(f"Resumed from {ckpt_dir} at step {counters['step']}")

    from terrain_diffusion_tpu_torch.training.datasets import LongDataset, batch_iterator

    train_ds = resolved.get("train_dataset")
    if train_ds is None:
        raise ValueError("config must define [train_dataset]")
    batches = batch_iterator(LongDataset(train_ds, shuffle=True, base_seed=seed), batch_size,
                             start=counters["step"] * batch_size)

    total_steps = max_steps or epochs * epoch_steps
    ema_ckpt_every = int(config.get("ema", {}).get("checkpoint_every_num_steps", 0))
    validate_epochs = int(config.get("evaluation", {}).get("validate_epochs", 0))
    running = {}
    metrics_f = open(os.path.join(save_dir, "metrics.jsonl"), "a") if rank0 else None

    def log(line):
        if rank0:
            print(json.dumps(line), flush=True)
            metrics_f.write(json.dumps(line) + "\n")
            metrics_f.flush()

    try:
        while counters["step"] < total_steps:
            batch = {k: v for k, v in next(batches).items()
                     if isinstance(v, (np.ndarray, list)) and k != "path"}
            t0 = time.perf_counter()
            metrics = trainer.train_step(state, batch,
                                         step_generator(seed, counters["step"]), counters)
            metrics["step_ms"] = (time.perf_counter() - t0) * 1e3
            for k, v in distributed.reduce_metrics(metrics, device).items():
                running.setdefault(k, []).append(v)
            step = counters["step"]
            if rank0 and ema_ckpt_every and state.get("ema") and step % ema_ckpt_every == 0:
                state["ema"].checkpoint(step)
            if step % log_every == 0 or step >= total_steps:
                log({"step": step, "seen": counters["seen"],
                     **{k: float(np.mean(v)) for k, v in running.items()}})
                running.clear()
            if save_epochs and step % (epoch_steps * save_epochs) == 0 and step > 0:
                counters["epoch"] = step // epoch_steps
                if rank0:
                    trainer.save_checkpoint(state, ckpt_dir, counters)
                    print(f"checkpoint saved at step {step}")
            if (validate_epochs and step > 0
                    and step % (epoch_steps * validate_epochs) == 0
                    and resolved.get("val_dataset") is not None
                    and hasattr(trainer, "evaluate_full")):
                ev = trainer.evaluate_full(state, resolved["val_dataset"],
                                           stream_generator(seed, STEP_STREAM, step, 1))
                log({"step": step, **ev})
    finally:
        batches.close()
        if metrics_f is not None:
            metrics_f.close()
    if rank0:
        trainer.save_checkpoint(state, ckpt_dir, counters)
    return trainer, state, counters


@click.command()
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("-o", "--override", "overrides", multiple=True,
              help="dotted config overrides key.path=value")
@click.option("--ckpt", "ckpt_path", default=None, help="checkpoint directory to resume from")
@click.option("--max-steps", type=int, default=None, help="cap total steps (debugging)")
@click.option("--log-every", type=int, default=32,
              help="metrics cadence in steps (1 shows per-step values: a NaN anywhere "
                   "poisons the default averaged window)")
@click.option("--device", default="cuda", show_default=True,
              help="torch device to train on; 'cpu' only when asked for")
def main(config_path, overrides, ckpt_path, max_steps, log_every, device):
    """Train a model from a .cfg config."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise click.UsageError("no CUDA card is available: pass --device cpu to train on the CPU")
    config = load_config(config_path)
    apply_overrides(config, overrides)
    # one process per visible card, as JAX trains on every local device
    dev = torch.device(device)
    world_size = (torch.cuda.device_count()
                  if dev.type == "cuda" and dev.index is None else None)
    run_training(config, ckpt_path=ckpt_path, max_steps=max_steps, log_every=log_every,
                 device=device, world_size=world_size)


if __name__ == "__main__":
    main()
