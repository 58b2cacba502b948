"""Data-parallel training of the autoencoder, GAN and perceptron trainers on
the CPU, over gloo: a 2-rank run of 3 steps equals the 1-rank run of the
same seed and global batch within 1e-5 (rtol and atol): weights, Adam
moments and count, EMA, counters, the logged metrics and, for the GAN, the
discriminator and its optimizer; only rank 0 wrote files.  The draws
(posterior noise, the GAN's latents, inject noise and crops, the
perceptron's dropout and ensemble members) are made for the global batch
and cut to each rank's rows; the GAN's KL term (kl_weight 0.05) takes the
global batch's mean and variance, and its R1 step (step 0 and 2) and both
optimizers' gradient means run too.  A 3-rank GAN run of a global batch of
4 is replicated on every rank.  tests/test_torch_data_parallel.py covers
the diffusion and consistency trainers.
"""
import os

import pytest
import torch

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


@pytest.mark.parametrize("kind,world", [("autoencoder", 2), ("gan", 2), ("perceptron", 2),
                                        ("gan", 3)])
def test_ranks_equal_one_process(kind, world, tmp_path):
    dp.train(dp.config(kind, str(tmp_path / "one")), 3)
    counters = launch(dp.rank_run, world, kind, str(tmp_path / "many"), 3, 4, True)
    assert all(c == {"epoch": 0, "step": 3, "seen": 12} for c in counters)
    assert sorted(os.listdir(tmp_path / "many")) == ["rank0"]  # only rank 0 wrote
    one, many = dp.run_files(str(tmp_path / "one")), dp.run_files(str(tmp_path / "many/rank0"))
    assert ("gan" in one) == (kind == "gan") and len(one["metrics"]) == 3
    dp.assert_close(many, one)
