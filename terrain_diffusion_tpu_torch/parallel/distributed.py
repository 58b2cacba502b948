"""Data-parallel training over ``torch.distributed``: the process launcher
and the collectives the train step uses.

JAX trains on every local device of one program, where ``jit`` inserts the
gradient all-reduce.  The port runs one process per card (NCCL) or per CPU
rank (gloo): ``launch`` starts them, each joins the default process group
at ``tcp://127.0.0.1:<free port>`` with one torch thread, and every rank
computes its rows of the global batch.  The train step averages the
gradients over the ranks (``all_reduce_mean_``, one flattened buffer), so
every rank applies the same update; a batch the world size does not
divide is replicated and its N equal gradients average to the one.

Nothing here falls back: a failed ``init_process_group`` or collective
raises, and ``launch`` ends every rank and raises when one fails.  Every
rank runs the same work between two collectives (validation included,
``training/train.py``), so no rank waits on another longer than a step.
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from terrain_diffusion_tpu_torch.parallel.mesh import Rows, in_process_group


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(backend: str, rank: int, world_size: int, port: int,
               timeout: float | None = None):
    """Join the default process group at ``tcp://127.0.0.1:<port>``, whose
    collectives give up after ``timeout`` seconds (torch's default when
    None); under NCCL the rank's card becomes the current device first."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world_size, **kw)


def _rank_main(rank, fn, world_size, port, backend, timeout, args, out_dir):
    torch.set_num_threads(1)
    init_group(backend, rank, world_size, port, timeout)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    # a file, not a queue: a tensor sent through a queue is a handle to this
    # process's shared memory, gone once it exits, and a pipe holds 64 KiB
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch(fn, world_size: int, *args, backend: str = "gloo", timeout: float | None = None):
    """Run ``fn(*args)`` in ``world_size`` new processes, one per rank of a
    fresh default process group over ``backend``; returns each rank's
    return value, in rank order.  ``fn`` and its arguments must pickle (a
    module-level function).  It waits as long as the ranks run: a hung
    collective ends at the group's ``timeout`` (seconds; torch's default
    when None).  When a rank fails, the others are ended and
    ``torch.multiprocessing.ProcessRaisedException`` carries its traceback
    (``ProcessExitedException`` when it died without one)."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, args=(fn, world_size, free_port(), backend, timeout, args,
                                   out_dir), nprocs=world_size, join=True)
        out = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def all_reduce_mean_(tensors) -> None:
    """Average ``tensors`` (one dtype, one device) over the ranks in place,
    as one flattened buffer: one collective; a no-op outside a process
    group.  At world size 1 the values come back unchanged, bit for bit."""
    if not in_process_group():
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def reduce_metrics(metrics: dict, device) -> dict:
    """The logged metrics over the ranks: the mean of each, but the max of
    a ``max_*`` metric (a batch maximum); the dict itself outside a
    process group.  The values travel on ``device`` under NCCL, on the CPU
    under gloo."""
    if not in_process_group():
        return metrics
    if dist.get_backend() != "nccl":
        device = "cpu"
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=device)
    maxed = torch.tensor([k.startswith("max_") for k in keys], device=device)
    mean, top = vals.clone(), vals.clone()
    dist.all_reduce(mean)
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    out = torch.where(maxed, top, mean / dist.get_world_size())
    return dict(zip(keys, out.tolist()))


def batch_mean(x: torch.Tensor, dims, rows: Rows | None) -> torch.Tensor:
    """``x.mean(dims)`` over the GLOBAL batch (dims include 0) where the
    batch is sharded (``rows.sharded``): the local sums are all-reduced
    through ``torch.distributed.nn``, whose backward sums the gradients
    over the ranks, so that after the train step's gradient average each
    rank holds the gradient of the global statistic.  Elsewhere
    ``x.mean(dims)`` itself."""
    if rows is None or not rows.sharded:
        return x.mean(dim=dims)
    from torch.distributed.nn.functional import all_reduce

    count = 1
    for d in dims:
        count *= x.shape[d]
    return all_reduce(x.sum(dim=dims)) / (count * rows.total // (rows.stop - rows.start))


def batch_var(x: torch.Tensor, dims, rows: Rows | None) -> torch.Tensor:
    """The population variance over the global batch (``x.var(dims,
    correction=0)`` where the batch is not sharded), two-pass as
    ``torch.var``: the global mean first, then the mean squared deviation."""
    if rows is None or not rows.sharded:
        return x.var(dim=dims, correction=0)
    keep = [d % x.dim() for d in dims]
    mean = batch_mean(x, dims, rows)
    shape = [1 if d in keep else s for d, s in enumerate(x.shape)]
    return batch_mean(torch.square(x - mean.reshape(shape)), dims, rows)
