"""Command-line helpers shared by the port's servers and evaluation CLIs
(counterpart of ``terrain_diffusion_tpu.common.cli_helpers``)."""
from __future__ import annotations

import argparse
import json
import re

import torch


def parse_cache_size(value: str | None) -> int | None:
    """'100M' / '1G' / '500K' -> bytes."""
    if value is None:
        return None
    match = re.fullmatch(r"(\d+(?:\.\d+)?)\s*([KMGT]?)B?", value.strip().upper())
    if not match:
        raise ValueError(f"Invalid size format: {value}. Use e.g. 100M, 1G, 500K")
    mult = {"": 1, "K": 1024, "M": 1024 ** 2, "G": 1024 ** 3, "T": 1024 ** 4}
    return int(float(match.group(1)) * mult[match.group(2)])


def parse_kwargs(items) -> dict:
    """('k=v', ...) -> dict with JSON-typed values."""
    result = {}
    for item in items:
        if "=" not in item:
            raise ValueError(f"Expected key=value format, got: {item}")
        key, value = item.split("=", 1)
        try:
            result[key] = json.loads(value)
        except json.JSONDecodeError:
            result[key] = value
    return result


def parse_batch_sizes(value: str):
    """'1,4' -> [1, 4]; '4' -> 4 (the pipeline's latents_batch_size)."""
    if "," in value:
        return [int(x.strip()) for x in value.split(",")]
    return int(value)


def _missing_card(device: str) -> str | None:
    """The usage error for a device that asks for a card torch cannot see."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        return f"--device {device}: torch sees no CUDA device; pass --device cpu to run on the CPU"
    return None


def check_device(ap: argparse.ArgumentParser, device: str):
    """Exit with a usage error, before any model is loaded, when the device
    asks for a card that torch cannot see: no quiet fallback to the CPU."""
    message = _missing_card(device)
    if message:
        ap.error(message)


def click_check_device(device: str):
    """``check_device`` for the click entry points (the evaluation CLIs)."""
    import click

    message = _missing_card(device)
    if message:
        raise click.UsageError(message)
