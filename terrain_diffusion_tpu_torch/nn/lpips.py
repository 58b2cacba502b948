"""LPIPS perceptual distance (AlexNet variant) as an ``nn.Module``
(counterpart of ``terrain_diffusion_tpu.nn.lpips``).

The lpips package's forward: the input scaling layer, torchvision AlexNet's
feature taps after each ReLU, channel-unit-normalized squared differences,
the learned non-negative 1x1 linear heads, bilinear upsampling of each
spatial map to the input size, and the sum over the taps.  The modules
carry torchvision's and the lpips package's state-dict names
(``features.{i}.weight``, ``lin{k}.model.1.weight``), so a merged state
dict loads with ``load_state_dict``; ``load_torch_checkpoint`` and
``from_state_dict`` also take the ``lin{k}.weight``, ``net.features.*`` and
``net.slice{k}.*`` spellings, as the JAX package's loader does.

Pretrained weights are not bundled; without them the autoencoder trainer
uses its multi-scale gradient surrogate.  Inputs and outputs are NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from terrain_diffusion_tpu_torch.evaluation.inception import resize_bilinear_no_aa

_SHIFT = (-0.030, -0.088, -0.188)  # lpips ScalingLayer constants
_SCALE = (0.458, 0.448, 0.450)
# torchvision alexnet.features conv layers: (torch_index, in, out, k, stride, pad)
ALEX_CONVS = [
    (0, 3, 64, 11, 4, 2),
    (3, 64, 192, 5, 1, 2),
    (6, 192, 384, 3, 1, 1),
    (8, 384, 256, 3, 1, 1),
    (10, 256, 256, 3, 1, 1),
]
TAP_CHANNELS = [64, 192, 384, 256, 256]
EPS = 1e-10


class _NetLin(nn.Module):
    """The lpips package's NetLinLayer: dropout (inactive in eval) and a
    1x1 conv without bias to one channel."""

    def __init__(self, channels: int, device):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(channels, 1, 1, bias=False, device=device))


class LPIPS(nn.Module):
    """The network, its weights left unset on the ``meta`` device
    (``from_state_dict`` loads them)."""

    def __init__(self, device="meta"):
        super().__init__()
        layers = [nn.Identity()] * 13  # torchvision indices; only the convs hold weights
        for ti, cin, cout, k, stride, pad in ALEX_CONVS:
            layers[ti] = nn.Conv2d(cin, cout, k, stride=stride, padding=pad, device=device)
        self.features = nn.Sequential(*layers)
        for k, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{k}", _NetLin(c, device))
        self.eval()

    def _taps(self, x):
        """x (B, 3, H, W) in [-1, 1] -> the 5 post-ReLU feature taps."""
        f = self.features
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        x = (x - shift) / scale
        taps = [F.relu(f[0](x))]
        taps.append(F.relu(f[3](F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(f[6](F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(f[8](taps[-1])))
        taps.append(F.relu(f[10](taps[-1])))
        return taps

    def forward(self, x0, x1, spatial: bool = True):
        """LPIPS(x0, x1) of NHWC 3-channel inputs scaled to [-1, 1]: a
        (B, H, W, 1) map when ``spatial``, else (B,)."""
        h, w = x0.shape[1], x0.shape[2]
        t0 = self._taps(x0.permute(0, 3, 1, 2))
        t1 = self._taps(x1.permute(0, 3, 1, 2))
        total = None
        for k, (f0, f1) in enumerate(zip(t0, t1)):
            d = torch.square(_unit_normalize(f0) - _unit_normalize(f1))
            v = getattr(self, f"lin{k}").model[1](d).permute(0, 2, 3, 1)
            v = resize_bilinear_no_aa(v, (h, w)) if spatial else v.mean(dim=(1, 2), keepdim=True)
            total = v if total is None else total + v
        return total if spatial else total.reshape(-1)


def _unit_normalize(x):
    return x / torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True) + EPS)


def rekey(state: dict) -> dict:
    """Torchvision / lpips names from the other spellings: ``net.features.*``
    (a torchvision dump) and ``net.slice{k}.{i}.*`` (the lpips package keeps
    each layer's torchvision index inside its slice) to ``features.{i}.*``,
    and ``lin{k}.weight`` to ``lin{k}.model.1.weight``."""
    out = {}
    for k, v in state.items():
        if k.startswith("net.features"):
            k = k[len("net."):]
        elif k.startswith("net.slice"):
            k = "features." + k.split(".", 2)[2]
        elif k.startswith("lin") and k.count(".") == 1:
            k = k.replace(".", ".model.1.")
        out[k] = v
    return out


def from_state_dict(state: dict, device="cpu") -> LPIPS:
    """An LPIPS network on ``device`` from a state dict of tensors or numpy
    arrays (other keys, such as torchvision's classifier, are left out)."""
    net = LPIPS()
    names = set(net.state_dict())
    state = {k: torch.as_tensor(v).float() for k, v in rekey(state).items() if k in names}
    missing = names - set(state)
    if missing:
        raise KeyError(f"LPIPS state dict lacks {sorted(missing)}")
    net.load_state_dict(state, assign=True)
    return net.to(device).requires_grad_(False)


def load_torch_checkpoint(backbone_path: str, lins_path: str | None = None,
                          device="cpu") -> LPIPS:
    """LPIPS from .pth / .safetensors file(s); the lpips heads may live in a
    separate file (the lpips pip package ships only those)."""

    def load(path):
        if path.endswith(".safetensors"):
            from safetensors.torch import load_file

            return dict(load_file(path))
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        return dict(obj)

    state = load(backbone_path)
    if lins_path:
        state.update(load(lins_path))
    return from_state_dict(state, device)


def make_perceptual_fn(net: LPIPS):
    """perceptual_fn(recon, target) for the VAE trainer: per-image [-1, 1]
    range normalization from the target's min / max, the reconstruction
    clamped, grayscale repeated to 3 channels, the spatial LPIPS mean."""

    def fn(recon, target):
        ref_min = torch.amin(target, dim=(1, 2, 3), keepdim=True)
        ref_max = torch.amax(target, dim=(1, 2, 3), keepdim=True)
        ref_range = torch.clamp((ref_max - ref_min) * 1.1, min=0.1)
        ref_center = (ref_min + ref_max) / 2
        n_ref = (target - ref_center) / ref_range * 2
        n_rec = torch.clamp((recon - ref_center) / ref_range * 2, -1, 1)
        n_ref3 = n_ref[..., :1].repeat(1, 1, 1, 3)
        n_rec3 = n_rec[..., :1].repeat(1, 1, 1, 3)
        return net(n_ref3, n_rec3, spatial=True).mean()

    return fn
