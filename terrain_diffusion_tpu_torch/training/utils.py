"""Training utilities (counterpart of ``terrain_diffusion_tpu/training/utils.py``)."""
from __future__ import annotations

import contextlib
import json
import os
import shutil

import torch


class SerializableDict(dict):
    """Attribute-style dict with a JSON round trip (the epoch / step / seen
    counters)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def state_dict(self):
        return dict(self)

    def load_state_dict(self, state):
        self.update(state)

    def save(self, path):
        with open(path, "w") as f:
            json.dump(dict(self), f)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f))


@contextlib.contextmanager
def temporary_weights(model: torch.nn.Module, state: dict):
    """Run a block with ``state`` (e.g. EMA weights) loaded into ``model``,
    and the training weights restored on exit (JAX: ``temporary_params``)."""
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(state, strict=False)
    try:
        yield model
    finally:
        model.load_state_dict(saved)


_CHECKPOINT_EXTENSIONS = (".safetensors", ".pt", ".json", ".txt", ".jsonl")


def safe_rmtree(path: str):
    """Remove a checkpoint directory, refusing if it holds a file that does
    not look like a checkpoint artifact."""
    for _root, _dirs, files in os.walk(path):
        for f in files:
            if not f.endswith(_CHECKPOINT_EXTENSIONS):
                raise RuntimeError(f"refusing to delete {path}: non-checkpoint file {f!r}")
    shutil.rmtree(path)


def to_cpu(tree):
    """A nested dict / list of tensors with every tensor detached on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree
