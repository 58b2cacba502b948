"""The port's data-parallel training on the CPU, over gloo
(terrain_diffusion_tpu_torch.parallel.distributed, training/train.py):

- a 2-rank run of 3 steps of the diffusion trainer (without and with block
  dropout 0.2) and of the consistency trainer equals the 1-rank run of the
  same seed and global batch within 1e-5 (rtol and atol): weights, Adam
  moments and count, EMA, counters and the logged metrics; only rank 0
  wrote files;
- a 3-rank run of a global batch of 4 (replicated on every rank) equals the
  1-rank run within 1e-5;
- a 2-rank run resumed at step 2 equals an uninterrupted 1-rank run;
- ``run_training(world_size=2)`` starts its own ranks, and the ``train``
  command asks for one rank per visible card on ``cuda`` only;
- a validation longer than the group's timeout ends no run (every rank
  validates);
- the collectives: the gradient mean, the metrics' reduction, a failing
  rank that ends the run with its traceback, and a slow rank ``launch``
  waits for.

Each rank is a spawned process pinned to one torch thread
(``distributed.launch``); tests/torch_dp_helpers.py holds the configs and
the rank function.  The other three trainers are in
tests/test_torch_data_parallel_trainers.py.
"""
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_helpers as dp
from terrain_diffusion_tpu_torch.parallel.distributed import launch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_and_many(kind, tmp_path, world, steps=3, batch_size=4):
    dp.train(dp.config(kind, str(tmp_path / "one"), batch_size), steps)
    counters = launch(dp.rank_run, world, kind, str(tmp_path / "many"), steps, batch_size,
                      True)
    assert all(c == {"epoch": 0, "step": steps, "seen": steps * batch_size} for c in counters)
    assert sorted(os.listdir(tmp_path / "many")) == ["rank0"]  # only rank 0 wrote
    one, many = dp.run_files(str(tmp_path / "one")), dp.run_files(str(tmp_path / "many/rank0"))
    assert len(one["metrics"]) == steps and os.listdir(tmp_path / "many/rank0/phema")
    dp.assert_close(many, one)
    return one


@pytest.mark.parametrize("kind", ["diffusion", "dropout", "consistency"])
def test_two_ranks_equal_one_process(kind, tmp_path):
    one = _one_and_many(kind, tmp_path, 2)
    assert np.isfinite(one["metrics"][-1]["loss"])


def test_three_ranks_replicate_an_indivisible_batch(tmp_path):
    _one_and_many("diffusion", tmp_path, 3)


def test_resumed_two_rank_run_equals_an_uninterrupted_run(tmp_path):
    dp.train(dp.config("dropout", str(tmp_path / "one")), 3)
    launch(dp.rank_run, 2, "dropout", str(tmp_path / "many"), 2)
    counters = launch(dp.rank_run, 2, "dropout", str(tmp_path / "many"), 3)
    assert counters[1] == {"epoch": 0, "step": 3, "seen": 12}
    dp.assert_close(dp.run_files(str(tmp_path / "many")), dp.run_files(str(tmp_path / "one")))


def _h5_images(path, n=4, size=32):
    """A tiny dataset in the reference schema (as tests/test_torch_training_run.py
    writes it, at 32 x 32)."""
    import h5py

    rng = np.random.default_rng(0)
    lat = size // 8
    with h5py.File(path, "w") as f:
        for chunk in range(n):
            g = f.create_group(f"90/{chunk}/0")
            d = g.create_dataset("latent", data=rng.standard_normal(
                (8, 8, lat, lat)).astype(np.float16))
            g.create_dataset("lowfreq", data=rng.standard_normal((lat, lat)).astype(np.float32))
            g.create_dataset("lowres_exact", data=rng.standard_normal(
                (lat, lat)).astype(np.float32))
            g.create_dataset("climate", data=rng.standard_normal(
                (19, lat, lat)).astype(np.float32))
            r = g.create_dataset("residual", data=rng.standard_normal(
                (size, size)).astype(np.float32))
            for dset in (d, r):
                dset.attrs["pct_land"] = 0.5
                dset.attrs["split"] = "train"
            g.attrs["beauty_score"] = 1.0


def test_run_training_starts_its_own_ranks(tmp_path):
    """``world_size=2`` on the CPU: two gloo processes, one result."""
    h5 = str(tmp_path / "data.h5")
    _h5_images(h5)
    cfg = dp.config("diffusion", str(tmp_path / "run"))
    cfg["model"]["in_channels"] = 5  # the residual and 4 latent channels
    cfg["train_dataset"] = {
        "@dataset": "h5_decoder_terrain", "h5_file": h5, "crop_size": 16,
        "pct_land_ranges": [[0, 1]], "subset_resolutions": [90], "residual_mean": 0.0,
        "residual_std": 1.0, "split": "train", "sigma_data": 0.5}
    trainer, state, counters = dp.train(cfg, 2, world_size=2)
    assert trainer is None and state is None and counters["step"] == 2
    files = dp.run_files(str(tmp_path / "run"))
    assert [m["step"] for m in files["metrics"]] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in files["metrics"])


def test_every_rank_validates_within_the_group_timeout(tmp_path):
    """A validation that lasts longer than the group's collective timeout
    (12 s against 8 s) ends no run: every rank validates, so none waits in
    the next step's all-reduce; rank 0 alone logs the result."""
    counters = launch(dp.rank_run_validating, 2, str(tmp_path), 3, 12.0, timeout=8.0)
    assert counters == [({"epoch": 0, "step": 3, "seen": 12}, 1)] * 2
    assert sorted(os.listdir(tmp_path)) == ["rank0"]
    metrics = dp.run_files(str(tmp_path / "rank0"))["metrics"]
    assert [m["step"] for m in metrics] == [1, 2, 2, 3]
    assert np.isfinite(metrics[2]["val_loss"])


def _slow_rank(sleep_s):
    import time

    import torch.distributed as dist

    dist.barrier()
    if dist.get_rank() == 1:
        time.sleep(sleep_s)
    return dist.get_rank()


def test_launch_waits_for_a_slow_rank():
    """``launch`` has no deadline of its own: it returns once the last rank
    does, here one that outlives its peer by seconds."""
    assert launch(_slow_rank, 2, 3.0) == [0, 1]


@pytest.mark.parametrize("device,cards,want", [("cuda", 2, 2), ("cuda", 1, 1),
                                                ("cuda:0", 2, None), ("cpu", 2, None)])
def test_train_command_asks_for_a_rank_per_card(monkeypatch, tmp_path, device, cards, want):
    """The ``train`` command, not ``run_training``, picks the world size:
    one rank per visible card on ``cuda`` without an index."""
    from click.testing import CliRunner

    from terrain_diffusion_tpu_torch.training import train as train_mod

    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(train_mod, "run_training", lambda config, **kw: seen.update(kw))
    cfg = tmp_path / "run.cfg"
    cfg.write_text("[training]\nbatch_size = 2\n")
    result = CliRunner().invoke(train_mod.main, ["--config", str(cfg), "--device", device])
    assert result.exit_code == 0, result.output
    assert seen["world_size"] == want and seen["device"] == device


def _collectives():
    import torch.distributed as dist

    from terrain_diffusion_tpu_torch.parallel.distributed import all_reduce_mean_, reduce_metrics

    r = dist.get_rank()
    grads = [torch.full((3,), float(r)), torch.full((2, 2), 2.0 * r)]
    all_reduce_mean_(grads)
    return [g.tolist() for g in grads], reduce_metrics({"loss": float(r), "max_g": float(r)},
                                                       "cpu")


def _fails():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()


def test_collectives_and_a_failing_rank():
    out = launch(_collectives, 3)
    assert out[0] == out[2]
    grads, metrics = out[0]
    assert grads == [[1.0] * 3, [[2.0, 2.0], [2.0, 2.0]]]
    assert metrics == {"loss": 1.0, "max_g": 2.0}
    with pytest.raises(mp.ProcessRaisedException, match="rank one fails on purpose"):
        launch(_fails, 2)
