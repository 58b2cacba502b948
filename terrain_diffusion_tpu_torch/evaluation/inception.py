"""InceptionV3 feature extractor (the FID variant) as an ``nn.Module``
(counterpart of ``terrain_diffusion_tpu.evaluation.inception``).

Torchvision's ``inception_v3`` with the pytorch-fid patches that match the
original TF graph: the avg-pool branches use ``count_include_pad=False``,
``Mixed_7c``'s pool branch is a max pool, and inputs are resized to
299 x 299 bilinearly without antialiasing and scaled from [0, 1] to
[-1, 1].  Each conv is ``{name}.conv`` followed by batch norm in eval mode
(``{name}.bn``, eps 1e-3) and a ReLU, so a torchvision / pytorch-fid state
dict loads with ``load_state_dict``.  ``forward`` takes NHWC images and
returns the (B, 2048) pool3 features.  No pretrained weights ship with the
repository: point ``load_torch_checkpoint`` at a downloaded file.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3

# stem: (name, in, out, kernel, stride, padding) or ("maxpool",)
STEM = [
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    ("maxpool",),
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    ("maxpool",),
]
A_BLOCKS = [("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64), ("Mixed_5d", 288, 64)]
C_BLOCKS = [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)]
E_BLOCKS = [("Mixed_7b", 1280), ("Mixed_7c", 2048)]
FEATURE_DIM = 2048


def _conv_specs():
    """Every (qualified name, in, out, kernel) conv of the network."""
    specs = [(n, cin, cout, k) for n, cin, cout, k, _s, _p in
             (e for e in STEM if e[0] != "maxpool")]

    def add(block, suffix, cin, cout, k):
        specs.append((f"{block}.{suffix}", cin, cout, k))

    for name, cin, pf in A_BLOCKS:
        add(name, "branch1x1", cin, 64, (1, 1))
        add(name, "branch5x5_1", cin, 48, (1, 1))
        add(name, "branch5x5_2", 48, 64, (5, 5))
        add(name, "branch3x3dbl_1", cin, 64, (1, 1))
        add(name, "branch3x3dbl_2", 64, 96, (3, 3))
        add(name, "branch3x3dbl_3", 96, 96, (3, 3))
        add(name, "branch_pool", cin, pf, (1, 1))
    add("Mixed_6a", "branch3x3", 288, 384, (3, 3))
    add("Mixed_6a", "branch3x3dbl_1", 288, 64, (1, 1))
    add("Mixed_6a", "branch3x3dbl_2", 64, 96, (3, 3))
    add("Mixed_6a", "branch3x3dbl_3", 96, 96, (3, 3))
    for name, c7 in C_BLOCKS:
        add(name, "branch1x1", 768, 192, (1, 1))
        add(name, "branch7x7_1", 768, c7, (1, 1))
        add(name, "branch7x7_2", c7, c7, (1, 7))
        add(name, "branch7x7_3", c7, 192, (7, 1))
        add(name, "branch7x7dbl_1", 768, c7, (1, 1))
        add(name, "branch7x7dbl_2", c7, c7, (7, 1))
        add(name, "branch7x7dbl_3", c7, c7, (1, 7))
        add(name, "branch7x7dbl_4", c7, c7, (7, 1))
        add(name, "branch7x7dbl_5", c7, 192, (1, 7))
        add(name, "branch_pool", 768, 192, (1, 1))
    add("Mixed_7a", "branch3x3_1", 768, 192, (1, 1))
    add("Mixed_7a", "branch3x3_2", 192, 320, (3, 3))
    add("Mixed_7a", "branch7x7x3_1", 768, 192, (1, 1))
    add("Mixed_7a", "branch7x7x3_2", 192, 192, (1, 7))
    add("Mixed_7a", "branch7x7x3_3", 192, 192, (7, 1))
    add("Mixed_7a", "branch7x7x3_4", 192, 192, (3, 3))
    for name, _out in E_BLOCKS:
        cin = 1280 if name == "Mixed_7b" else 2048
        add(name, "branch1x1", cin, 320, (1, 1))
        add(name, "branch3x3_1", cin, 384, (1, 1))
        add(name, "branch3x3_2a", 384, 384, (1, 3))
        add(name, "branch3x3_2b", 384, 384, (3, 1))
        add(name, "branch3x3dbl_1", cin, 448, (1, 1))
        add(name, "branch3x3dbl_2", 448, 384, (3, 3))
        add(name, "branch3x3dbl_3a", 384, 384, (1, 3))
        add(name, "branch3x3dbl_3b", 384, 384, (3, 1))
        add(name, "branch_pool", cin, 192, (1, 1))
    return specs


CONV_SPECS = _conv_specs()


class _BatchNorm(nn.Module):
    """Batch norm's affine parameters and running statistics, applied in
    eval mode."""

    def __init__(self, channels, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean", torch.empty(channels, device=device))
        self.register_buffer("running_var", torch.empty(channels, device=device))


class BasicConv2d(nn.Module):
    """Conv without bias, batch norm (eval), ReLU: torchvision's naming."""

    def __init__(self, cin, cout, kernel, device):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, bias=False, device=device)
        self.bn = _BatchNorm(cout, device)

    def forward(self, x, stride=1, padding=(0, 0)):
        y = F.conv2d(x, self.conv.weight, stride=stride, padding=padding)
        y = F.batch_norm(y, self.bn.running_mean, self.bn.running_var, self.bn.weight,
                         self.bn.bias, training=False, eps=BN_EPS)
        return F.relu(y)


def _avg_pool_3x3_s1(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def resize_bilinear_no_aa(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel bilinear resize without antialiasing (torch
    ``F.interpolate(mode='bilinear', align_corners=False)``'s rule), NHWC,
    with the weights and the order of operations of the JAX package's."""
    _n, h, w, _c = x.shape
    oh, ow = size

    def axis_weights(in_len, out_len):
        pos = (np.arange(out_len) + 0.5) * (in_len / out_len) - 0.5
        lo = np.floor(pos).astype(np.int64)
        t = (pos - lo).astype(np.float32)
        return (torch.from_numpy(np.clip(lo, 0, in_len - 1)).to(x.device),
                torch.from_numpy(np.clip(lo + 1, 0, in_len - 1)).to(x.device),
                torch.from_numpy(t).to(x.device, x.dtype))

    y0, y1, ty = axis_weights(h, oh)
    x0, x1, tx = axis_weights(w, ow)
    ty = ty[None, :, None, None]
    tx = tx[None, None, :, None]
    rows = x[:, y0] * (1 - ty) + x[:, y1] * ty
    return rows[:, :, x0] * (1 - tx) + rows[:, :, x1] * tx


class InceptionV3(nn.Module):
    """The pool3 feature network, its weights left unset on the ``meta``
    device (``from_state_dict`` loads them); ``forward`` takes (B, 299, 299,
    3) NHWC images in [-1, 1]."""

    def __init__(self, device="meta"):
        super().__init__()
        for name, cin, cout, k in CONV_SPECS:
            parent = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(parent, part):
                    parent.add_module(part, nn.Module())
                parent = getattr(parent, part)
            parent.add_module(leaf, BasicConv2d(cin, cout, k, device))
        self.eval()

    def _conv(self, name, x, stride=1, padding=(0, 0)):
        mod = self
        for part in name.split("."):
            mod = getattr(mod, part)
        return mod(x, stride, padding)

    def _block_a(self, n, x):
        b1 = self._conv(f"{n}.branch1x1", x)
        b5 = self._conv(f"{n}.branch5x5_2", self._conv(f"{n}.branch5x5_1", x), padding=(2, 2))
        bd = self._conv(f"{n}.branch3x3dbl_1", x)
        bd = self._conv(f"{n}.branch3x3dbl_2", bd, padding=(1, 1))
        bd = self._conv(f"{n}.branch3x3dbl_3", bd, padding=(1, 1))
        bp = self._conv(f"{n}.branch_pool", _avg_pool_3x3_s1(x))
        return torch.cat([b1, b5, bd, bp], 1)

    def _block_b(self, x):
        b3 = self._conv("Mixed_6a.branch3x3", x, stride=2)
        bd = self._conv("Mixed_6a.branch3x3dbl_1", x)
        bd = self._conv("Mixed_6a.branch3x3dbl_2", bd, padding=(1, 1))
        bd = self._conv("Mixed_6a.branch3x3dbl_3", bd, stride=2)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)

    def _block_c(self, n, x):
        b1 = self._conv(f"{n}.branch1x1", x)
        b7 = self._conv(f"{n}.branch7x7_1", x)
        b7 = self._conv(f"{n}.branch7x7_2", b7, padding=(0, 3))
        b7 = self._conv(f"{n}.branch7x7_3", b7, padding=(3, 0))
        bd = self._conv(f"{n}.branch7x7dbl_1", x)
        bd = self._conv(f"{n}.branch7x7dbl_2", bd, padding=(3, 0))
        bd = self._conv(f"{n}.branch7x7dbl_3", bd, padding=(0, 3))
        bd = self._conv(f"{n}.branch7x7dbl_4", bd, padding=(3, 0))
        bd = self._conv(f"{n}.branch7x7dbl_5", bd, padding=(0, 3))
        bp = self._conv(f"{n}.branch_pool", _avg_pool_3x3_s1(x))
        return torch.cat([b1, b7, bd, bp], 1)

    def _block_d(self, x):
        b3 = self._conv("Mixed_7a.branch3x3_1", x)
        b3 = self._conv("Mixed_7a.branch3x3_2", b3, stride=2)
        b7 = self._conv("Mixed_7a.branch7x7x3_1", x)
        b7 = self._conv("Mixed_7a.branch7x7x3_2", b7, padding=(0, 3))
        b7 = self._conv("Mixed_7a.branch7x7x3_3", b7, padding=(3, 0))
        b7 = self._conv("Mixed_7a.branch7x7x3_4", b7, stride=2)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)

    def _block_e(self, n, x, pool: str):
        b1 = self._conv(f"{n}.branch1x1", x)
        b3 = self._conv(f"{n}.branch3x3_1", x)
        b3 = torch.cat([self._conv(f"{n}.branch3x3_2a", b3, padding=(0, 1)),
                        self._conv(f"{n}.branch3x3_2b", b3, padding=(1, 0))], 1)
        bd = self._conv(f"{n}.branch3x3dbl_1", x)
        bd = self._conv(f"{n}.branch3x3dbl_2", bd, padding=(1, 1))
        bd = torch.cat([self._conv(f"{n}.branch3x3dbl_3a", bd, padding=(0, 1)),
                        self._conv(f"{n}.branch3x3dbl_3b", bd, padding=(1, 0))], 1)
        # the FID variant: Mixed_7c pools with max (pytorch-fid FIDInceptionE_2)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if pool == "max"
                  else _avg_pool_3x3_s1(x))
        bp = self._conv(f"{n}.branch_pool", pooled)
        return torch.cat([b1, b3, bd, bp], 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for entry in STEM:
            if entry[0] == "maxpool":
                x = F.max_pool2d(x, 3, 2)
            else:
                name, _cin, _cout, _k, stride, pad = entry
                x = self._conv(name, x, stride, pad)
        for name, _cin, _pf in A_BLOCKS:
            x = self._block_a(name, x)
        x = self._block_b(x)
        for name, _c7 in C_BLOCKS:
            x = self._block_c(name, x)
        x = self._block_d(x)
        x = self._block_e("Mixed_7b", x, "avg")
        x = self._block_e("Mixed_7c", x, "max")
        return x.mean(dim=(2, 3))  # global average pool -> (B, 2048)


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) in [0, 255] or [0, 1] -> (B, 299, 299, 3) in [-1, 1]."""
    x = torch.as_tensor(x).float()
    if x.dim() == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    x = torch.where(torch.amax(torch.abs(x)) > 2.0, x / 255.0, x)  # [0, 255] -> [0, 1]
    return resize_bilinear_no_aa(x, (299, 299)) * 2.0 - 1.0


def from_state_dict(state: dict, device="cpu") -> InceptionV3:
    """The network on ``device`` from a torchvision-named state dict (tensors
    or numpy arrays); the classifier head (``fc.*``), ``num_batches_tracked``
    and other extra keys are left out, as pool3 features do not read them."""
    net = InceptionV3()
    names = set(net.state_dict())
    state = {k: torch.as_tensor(v).float() for k, v in state.items() if k in names}
    missing = names - set(state)
    if missing:
        raise KeyError(f"Inception state dict lacks {sorted(missing)[:8]}")
    net.load_state_dict(state, assign=True)
    return net.to(device).requires_grad_(False)


def load_torch_checkpoint(path: str, device="cpu") -> InceptionV3:
    """Inception weights from a .pth (torch.load) or .safetensors file."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return from_state_dict(load_file(path), device)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return from_state_dict(obj, device)


def make_feature_fn(net: InceptionV3):
    """feature_fn for evaluation.metrics' compute_fid / compute_kid: the
    network runs on the device of the images it is given."""

    @torch.no_grad()
    def fn(x):
        x = torch.as_tensor(x)
        return net.to(x.device)(preprocess(x))

    return fn


@functools.lru_cache(maxsize=1)
def _cached_net(path: str) -> InceptionV3:
    return load_torch_checkpoint(path)


def inception_feature_fn(weights_path: str):
    """Feature fn bound to a weights file (the network cached across calls)."""
    return make_feature_fn(_cached_net(weights_path))
