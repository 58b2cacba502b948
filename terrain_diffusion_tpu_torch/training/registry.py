"""Config + registry system (counterpart of
``terrain_diffusion_tpu/training/registry.py``, kept as its own copy).

INI-style ``.cfg`` files with JSON-typed values, sections that name a
registered factory via ``@registry=key`` and pass their remaining keys as
kwargs, dotted CLI overrides, and a ``resolve`` step that instantiates every
registered block.

Registries provided: ``scheduler``, ``model``, ``lr_sched``, ``dataset``,
``trainer``, ``utils``, populated by `build_registry()`.  A ``model`` entry
(``unet``, ``autoencoder``, ``perceptron``) resolves to a ``ModelSpec``: a
torch module holds its weights, so the trainer builds it
(``spec.build(device, generator)``) from the run's seed, where JAX's
stateless model is initialized by ``model.init(key)``.
"""
from __future__ import annotations

import json
from typing import Any, Callable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._factories: dict[str, Callable] = {}

    def register(self, key: str):
        def deco(fn):
            self._factories[key] = fn
            return fn
        return deco

    def get(self, key: str) -> Callable:
        if key not in self._factories:
            raise KeyError(f"no '{key}' in registry '{self.name}' "
                           f"(have: {sorted(self._factories)})")
        return self._factories[key]


REGISTRIES: dict[str, Registry] = {
    name: Registry(name)
    for name in ("scheduler", "model", "lr_sched", "dataset", "trainer", "utils")
}

scheduler_registry = REGISTRIES["scheduler"]
model_registry = REGISTRIES["model"]
lr_sched_registry = REGISTRIES["lr_sched"]
dataset_registry = REGISTRIES["dataset"]
trainer_registry = REGISTRIES["trainer"]
utils_registry = REGISTRIES["utils"]


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw.strip('"').strip("'")


def load_config(path: str) -> dict:
    """Parse an INI-style .cfg into a nested dict; dotted section names nest."""
    config: dict = {}
    section: dict | None = None
    with open(path) as f:
        for line in f:
            if line.strip().startswith("#"):
                line = ""
            else:
                # strip inline comments, but never split a '#' inside a
                # quoted value (tag="run#3", color="#aabbcc")
                out, quote = [], None
                for ch in line:
                    if quote:
                        out.append(ch)
                        if ch == quote:
                            quote = None
                    elif ch in "\"'":
                        quote = ch
                        out.append(ch)
                    elif ch == "#":
                        break
                    else:
                        out.append(ch)
                line = "".join(out).rstrip()
            line = line.strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                name = line[1:-1]
                node = config
                for part in name.split("."):
                    node = node.setdefault(part, {})
                section = node
            elif "=" in line and section is not None:
                key, val = line.split("=", 1)
                section[key.strip()] = _parse_value(val)
    return config


def set_nested_value(config: dict, dotted_key: str, value):
    """`a.b.c=value` override (reference `utils.py:74-91`)."""
    node = config
    parts = dotted_key.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = _parse_value(value) if isinstance(value, str) else value


def apply_overrides(config: dict, overrides) -> dict:
    for ov in overrides or ():
        if "=" not in ov:
            raise ValueError(f"override must be key.path=value, got {ov!r}")
        k, v = ov.split("=", 1)
        set_nested_value(config, k, v)
    return config


def resolve(config: dict) -> dict:
    """Instantiate every block carrying an `@registry=key` marker; returns a
    dict mapping section path -> instantiated object (plus raw config)."""

    def resolve_node(node):
        if not isinstance(node, dict):
            return node
        reg_key = None
        for k in node:
            if k.startswith("@"):
                reg_key = k
                break
        kwargs = {k: resolve_node(v) for k, v in node.items() if not k.startswith("@")}
        if reg_key is not None:
            registry = REGISTRIES[reg_key[1:]]
            factory = registry.get(node[reg_key])
            return factory(**kwargs)
        return kwargs

    return {k: resolve_node(v) for k, v in config.items()}


class ModelSpec:
    """A model configuration (``EDMUnetConfig``, ``EDMAutoencoderConfig`` or
    ``PerceptronConfig``), built on demand into its module."""

    def __init__(self, config):
        self.config = config

    def build(self, device, generator: "torch.Generator"):
        from terrain_diffusion_tpu_torch.nn.edm_autoencoder import (EDMAutoencoder,
                                                                   EDMAutoencoderConfig)
        from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
        from terrain_diffusion_tpu_torch.nn.perceptron import Perceptron, PerceptronConfig

        cls = {EDMUnetConfig: EDMUnet2D, EDMAutoencoderConfig: EDMAutoencoder,
               PerceptronConfig: Perceptron}[type(self.config)]
        return cls(self.config, device=device, generator=generator)


_BUILT = False


def build_registry():
    """Populate all registries (idempotent)."""
    global _BUILT
    if _BUILT:
        return
    _BUILT = True

    from terrain_diffusion_tpu_torch.nn.edm_autoencoder import EDMAutoencoderConfig
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnetConfig
    from terrain_diffusion_tpu_torch.nn.perceptron import PerceptronConfig
    from terrain_diffusion_tpu_torch.scheduler.dpmsolver import EDMSchedulerConfig
    from terrain_diffusion_tpu_torch.training import lr_sched as ls

    @scheduler_registry.register("edm_dpm")
    def make_scheduler(**kwargs):
        fields = {f for f in EDMSchedulerConfig.__dataclass_fields__}
        return EDMSchedulerConfig(**{k: v for k, v in kwargs.items() if k in fields})

    @model_registry.register("unet")
    def make_unet(**kwargs):
        return ModelSpec(EDMUnetConfig.from_dict(kwargs))

    @model_registry.register("autoencoder")
    def make_autoencoder(**kwargs):
        return ModelSpec(EDMAutoencoderConfig.from_dict(kwargs))

    @model_registry.register("perceptron")
    def make_perceptron(**kwargs):
        return ModelSpec(PerceptronConfig.from_dict(kwargs))

    @lr_sched_registry.register("sqrt")
    def make_sqrt(lr, ref_nimg, warmup_nimg=0, **_):
        return ls.SqrtLRScheduler(lr, ref_nimg, warmup_nimg)

    @lr_sched_registry.register("cosine")
    def make_cosine(lr, total_nimg=1e9, warmup_nimg=0, final_lr=0.0, **_):
        return ls.CosineLRScheduler(lr, total_nimg, warmup_nimg, final_lr)

    @lr_sched_registry.register("constant")
    def make_constant(lr, warmup_nimg=0, **_):
        return ls.ConstantLRScheduler(lr, warmup_nimg)

    @utils_registry.register("create_list")
    def create_list(*items, **kwargs):
        return list(items) or list(kwargs.values())

    # datasets + trainers register themselves on import
    from terrain_diffusion_tpu_torch.training import datasets as _datasets  # noqa: F401
    from terrain_diffusion_tpu_torch.training import trainers as _trainers  # noqa: F401
