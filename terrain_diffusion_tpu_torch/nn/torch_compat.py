"""Weights across packages and on disk.

- ``params_from_jax(model, tree)``: the JAX package's parameter pytree
  (numpy leaves) of an ``EDMUnet2D``, an ``EDMAutoencoder`` or a
  ``Perceptron`` as this package's state dict - HWIO -> OIHW for conv
  weights, (in, out) -> (out, in) for linear weights, names from the same
  tables as the JAX package's torch-compat name maps (``name_map``).
  ``params_to_jax(model)`` is its inverse (the ONNX exporter folds weights
  from these arrays, exactly as the JAX exporter does).
- ``load_model`` / ``save_model``: the reference directory layout
  (``config.json`` + ``model.safetensors`` in reference state-dict naming)
  for the three classes, chosen by the config's ``_class_name``.
  ``safetensors`` is imported only when a file is read or written.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from terrain_diffusion_tpu_torch.nn.edm_autoencoder import (EDMAutoencoder,
                                                           EDMAutoencoderConfig)
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.perceptron import Perceptron, PerceptronConfig


def _conv_res0_entries(prefix, tree_prefix, merged):
    """The learned resample (down (O, I, k, k) / up (I, O, k, k) as HWIO /
    HWOI) and the first conv (a 1x1 and a depthwise 3x3 when mobile) of a
    block with options ``merged``."""
    out = []
    if merged.get("resample_type") == "conv" and merged.get("resample_mode", "keep") != "keep":
        out.append((f"{prefix}.resample.weight", tree_prefix + ("resample", "w"), False))
    if merged.get("conv_type", "default") == "mobile":
        out.append((f"{prefix}.conv_res0.0.weight", tree_prefix + ("conv_res0_pw", "w"), False))
        out.append((f"{prefix}.conv_res0.1.weight", tree_prefix + ("conv_res0_dw", "w"), False))
    else:
        out.append((f"{prefix}.conv_res0.weight", tree_prefix + ("conv_res0", "w"), False))
    return out


def unet_name_map(model: EDMUnet2D):
    """(state-dict name, JAX tree path, is_linear) triples for an EDMUnet2D."""
    cfg = model.config
    out = []
    if model.noise_dims > 0:
        out.append(("noise_fourier.freqs", ("noise_fourier", "freqs"), False))
        if cfg.fourier_scale != "pos":
            out.append(("noise_fourier.phases", ("noise_fourier", "phases"), False))
        out.append(("noise_linear.weight", ("noise_linear", "w"), True))
    for i, (typ, _x, _w) in enumerate(cfg.conditional_inputs):
        base, tp = f"conditional_layers.{i}", ("conditional_layers", str(i))
        if typ == "float":
            out.append((f"{base}.0.freqs", tp + ("fourier", "freqs"), False))
            out.append((f"{base}.0.phases", tp + ("fourier", "phases"), False))
            out.append((f"{base}.1.weight", tp + ("linear", "w"), True))
        elif typ == "tensor":
            out.append((f"{base}.weight", tp + ("linear", "w"), True))
        else:  # embedding: (num, dim) in both layouts
            out.append((f"{base}.weight", tp + ("embed", "w"), False))
    if not cfg.disable_out_gain:
        out.append(("out_gain", ("out_gain",), False))

    def block_entries(prefix, tree_prefix, opts, cin, cout):
        merged = {**cfg.block_kwargs, **opts}
        entries = [(f"{prefix}.emb_gain", tree_prefix + ("emb_gain",), False)]
        entries += _conv_res0_entries(prefix, tree_prefix, merged)
        if model.emb_ch > 0:
            entries.append((f"{prefix}.emb_linear.weight", tree_prefix + ("emb_linear", "w"), True))
        entries.append((f"{prefix}.conv_res1.weight", tree_prefix + ("conv_res1", "w"), False))
        if cin != cout:
            entries.append((f"{prefix}.conv_skip.weight", tree_prefix + ("conv_skip", "w"), False))
        if merged.get("attention") and cout // merged.get("channels_per_head", 64) > 0:
            entries.append((f"{prefix}.attn_qkv.weight", tree_prefix + ("attn_qkv", "w"), False))
            entries.append((f"{prefix}.attn_proj.weight", tree_prefix + ("attn_proj", "w"), False))
        return entries

    for name, kind, cin, cout, opts in model.enc_plan:
        if kind == "conv":
            out.append((f"enc.{name}.weight", ("enc", name, "w"), False))
        else:
            out.extend(block_entries(f"enc.{name}", ("enc", name), opts, cin, cout))
    for name, _kind, cin, cout, opts in model.dec_plan:
        out.extend(block_entries(f"dec.{name}", ("dec", name), opts, cin, cout))
    out.append(("out_conv.weight", ("out_conv", "w"), False))
    out.append(("logvar_fourier.freqs", ("logvar_fourier", "freqs"), False))
    out.append(("logvar_fourier.phases", ("logvar_fourier", "phases"), False))
    out.append(("logvar_linear.weight", ("logvar_linear", "w"), True))
    return out


def autoencoder_name_map(model: EDMAutoencoder):
    """(state-dict name, JAX tree path, is_linear) triples for an
    EDMAutoencoder: the encoder's U-Net entries under ``encoder``, then the
    decoder's 1x1 conv, its blocks by plan index, the head, its gain and
    the logvar."""
    cfg = model.config
    out = [(f"encoder.{n}", ("encoder",) + p, lin) for n, p, lin in unet_name_map(model.encoder)]
    out.append(("decoder_conv.weight", ("decoder_conv", "w"), False))
    for idx, (name, cin, cout, opts) in enumerate(model.decoder_plan):
        prefix, tp = f"decoder.{idx}", ("decoder", name)
        merged = {**cfg.block_kwargs, **opts}
        out += [(f"{prefix}.emb_gain", tp + ("emb_gain",), False),
                *_conv_res0_entries(prefix, tp, merged),
                (f"{prefix}.conv_res1.weight", tp + ("conv_res1", "w"), False)]
        if cin != cout:
            out.append((f"{prefix}.conv_skip.weight", tp + ("conv_skip", "w"), False))
        if merged.get("attention") and cout // merged.get("channels_per_head", 64) > 0:
            out.append((f"{prefix}.attn_qkv.weight", tp + ("attn_qkv", "w"), False))
            out.append((f"{prefix}.attn_proj.weight", tp + ("attn_proj", "w"), False))
    out += [("out_conv.weight", ("out_conv", "w"), False), ("out_gain", ("out_gain",), False),
            ("logvar", ("logvar",), False)]
    return out


def perceptron_name_map(model: Perceptron):
    """(state-dict name, JAX tree path, is_linear) triples for a Perceptron:
    ``nets.{k}.{position}`` in each ensemble member's ``nn.Sequential``,
    which advances past every hidden activation (and Dropout)."""
    return [(f"nets.{k}.{pos}.{kind}", (f"net{k}", f"l{i}", kind[0]), kind == "weight")
            for k, layers in enumerate(model.linear_positions())
            for i, pos in enumerate(layers)
            for kind in (("weight", "bias") if model.config.bias else ("weight",))]


def name_map(model):
    """The (state-dict name, JAX tree path, is_linear) triples of ``model``:
    the leaves of the JAX package's parameter tree."""
    if isinstance(model, EDMAutoencoder):
        return autoencoder_name_map(model)
    if isinstance(model, Perceptron):
        return perceptron_name_map(model)
    return unet_name_map(model)


def _tree_get(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def params_from_jax(model, tree: dict) -> dict:
    """State dict (CPU float32 tensors) from a JAX parameter pytree."""
    state = {}
    for tname, path, linear in name_map(model):
        arr = np.asarray(_tree_get(tree, path), dtype=np.float32)
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif arr.ndim == 2 and linear:  # (in, out) -> (out, in)
            arr = arr.T
        state[tname] = torch.from_numpy(np.array(arr, np.float32))
    return state


def params_to_jax(model) -> dict:
    """The inverse of ``params_from_jax``: ``model``'s state as the JAX
    package's parameter pytree of contiguous float32 numpy arrays (OIHW ->
    HWIO, (out, in) -> (in, out)), through the same name map."""
    state = model.state_dict()
    tree: dict = {}
    for tname, path, linear in name_map(model):
        arr = state[tname].detach().to("cpu", torch.float32).numpy()
        if arr.ndim == 4:  # OIHW -> HWIO
            arr = np.transpose(arr, (2, 3, 1, 0))
        elif arr.ndim == 2 and linear:  # (out, in) -> (in, out)
            arr = arr.T
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr, np.float32, order="C")
    # a U-Net's tree has its "enc" and "dec" levels even where one is empty
    # (an encode-only net: the autoencoder's encoder)
    for unet, sub in ((EDMUnet2D, tree), (EDMAutoencoder, tree.get("encoder"))):
        if isinstance(model, unet):
            sub.setdefault("enc", {})
            sub.setdefault("dec", {})
    return tree


def load_model(path: str, *, device):
    """EDMUnet2D, EDMAutoencoder or Perceptron (by ``_class_name``) from a
    reference-format directory, in eval mode."""
    from safetensors.torch import load_file

    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cls_name = cfg.get("_class_name", "EDMUnet2D")
    gen = torch.Generator().manual_seed(0)
    if cls_name == "EDMAutoencoder":
        model = EDMAutoencoder(EDMAutoencoderConfig.from_dict(cfg), device=device, generator=gen)
    elif cls_name == "Perceptron":
        model = Perceptron(PerceptronConfig.from_dict(cfg), device=device, generator=gen)
    elif cls_name == "EDMUnet2D":
        model = EDMUnet2D(EDMUnetConfig.from_dict(cfg), device=device, generator=gen)
    else:
        raise ValueError(f"unknown model class {cls_name!r} in {path}")
    model.load_state_dict(load_file(os.path.join(path, "model.safetensors")))
    return model.eval()


def save_model(model, path: str):
    """Write `model` in the reference directory format."""
    from safetensors.torch import save_file

    model.save_config(path)
    state = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    save_file(state, os.path.join(path, "model.safetensors"))
