"""LPIPS, the AlexNet variant (the JAX package's evaluation/lpips_jax.py;
the `lpips` package's LPIPS(net='alex'), Zhang et al. 2018, as the
reference's eval protocol uses it, eval/eval_ggrt.py:151-152, 331).

  1. inputs in [-1, 1] are shifted and scaled by the ScalingLayer constants,
  2. torchvision-AlexNet `features` runs, and its five post-ReLU outputs
     are tapped,
  3. each tap is unit-normalised over channels (eps 1e-10), and the two
     images' taps are differenced and squared,
  4. a non-negative 1x1 "lin" convolution per tap, averaged over space,
  5. the five scores are summed.

The module's state_dict names are torchvision's (`features.{0,3,6,8,10}`)
and the lpips package's (`lin{i}.model.1.weight`), so both packages' state
dicts load without a layout change (`load_state_dicts`). `load_npz` reads
the .npz that the JAX package's `save_weights` writes (flax HWIO kernels),
and `save_weights` writes it.
No pretrained weights are shipped.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# lpips.ScalingLayer constants (published in the lpips package).
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet `features`: (out channels, kernel, stride, padding),
# None for a 3x3 / 2 max-pool; a ReLU after every convolution.
ALEX = [(64, 11, 4, 2), None, (192, 5, 1, 2), None, (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
TAP_CHANNELS = (64, 192, 384, 256, 256)
FEATURE_INDEX = (0, 3, 6, 8, 10)   # the convolutions' places in `features`


class _Lin(nn.Module):
    """The lpips package's NetLinLayer without its dropout: model.1 is the
    1x1 convolution (no bias), clamped to non-negative weights when used."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return F.conv2d(x, self.model[1].weight.clamp(min=0.0))


class LPIPS(nn.Module):
    """LPIPS(alex) distance of (b, 3, h, w) images in [-1, 1] -> (b,)."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for spec in ALEX:
            if spec is None:
                layers.append(nn.MaxPool2d(3, 2))   # VALID, as flax's max_pool
                continue
            c, k, s, p = spec
            layers += [nn.Conv2d(c_in, c, k, s, p), nn.ReLU()]
            c_in = c
        self.features = nn.Sequential(*layers)
        for i, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{i}", _Lin(c))
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1), persistent=False)

    def taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        out = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                out.append(x)
        return out

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        taps_a = self.taps((a - self.shift) / self.scale)
        taps_b = self.taps((b - self.shift) / self.scale)
        total = 0.0
        for i, (fa, fb) in enumerate(zip(taps_a, taps_b)):
            fa = fa / torch.sqrt((fa**2).sum(dim=1, keepdim=True) + 1e-10)
            fb = fb / torch.sqrt((fb**2).sum(dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((fa - fb) ** 2).mean(dim=(1, 2, 3))
        return total


def state_dict_from_flax(params: dict) -> dict:
    """The JAX package's flax tree ({"net": {"conv{i}": {"kernel" HWIO,
    "bias"}}, "lin{i}": HWIO (1, 1, c, 1)}) -> this module's state_dict."""
    out = {}
    for i, ti in enumerate(FEATURE_INDEX):
        conv = params["net"][f"conv{i}"]
        out[f"features.{ti}.weight"] = torch.tensor(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy())
        out[f"features.{ti}.bias"] = torch.tensor(np.asarray(conv["bias"]))
    for i in range(len(TAP_CHANNELS)):
        out[f"lin{i}.model.1.weight"] = torch.tensor(np.asarray(params[f"lin{i}"]).transpose(3, 2, 0, 1).copy())
    return out


def flax_from_state_dicts(alexnet_sd: dict, lpips_sd: dict) -> dict:
    """torchvision alexnet and lpips package state dicts -> the JAX package's
    flax tree (its convert_torch_state_dicts): OIHW kernels to HWIO."""
    params: dict = {"net": {}}
    for i, ti in enumerate(FEATURE_INDEX):
        params["net"][f"conv{i}"] = {
            "kernel": np.asarray(alexnet_sd[f"features.{ti}.weight"]).transpose(2, 3, 1, 0),
            "bias": np.asarray(alexnet_sd[f"features.{ti}.bias"]),
        }
    for i in range(len(TAP_CHANNELS)):
        params[f"lin{i}"] = np.asarray(lpips_sd[f"lin{i}.model.1.weight"]).transpose(2, 3, 1, 0)
    return params


def save_weights(path: str, alexnet_sd: dict, lpips_sd: dict) -> None:
    """The .npz of the JAX package's save_weights, which load_npz and JAX's
    lpips_fn read."""
    np.savez(path, params=np.asarray(flax_from_state_dicts(alexnet_sd, lpips_sd), dtype=object))


def load_state_dicts(model: LPIPS, alexnet_sd: dict, lpips_sd: dict) -> LPIPS:
    """Load a torchvision alexnet state dict (its `features.*` entries) and
    an lpips package state dict (its `lin{i}.model.1.weight` entries); the
    other entries of either (the classifier, the lpips copy of the trunk)
    are not used."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in alexnet_sd.items() if k.startswith("features.")}
    sd.update({k: torch.as_tensor(np.asarray(v)) for k, v in lpips_sd.items()
               if k.startswith("lin") and k.endswith(".model.1.weight")})
    model.load_state_dict(sd)
    return model


def load_npz(model: LPIPS, path: str) -> LPIPS:
    """Load the .npz that the JAX package's save_weights writes."""
    with np.load(path, allow_pickle=True) as f:
        params = f["params"].item()
    model.load_state_dict(state_dict_from_flax(params))
    return model


_cached: Optional[tuple] = None


def lpips_fn(weights_path: str, device="cuda"):
    """A callable lpips(a, b) -> float for (3, h, w) images in [0, 1] (tensors
    or arrays), with the network from `weights_path` (an .npz as JAX's
    save_weights writes) on `device`; the last one built is kept."""
    global _cached
    device = torch.device(device)
    if _cached is not None and _cached[0] == (weights_path, device):
        return _cached[1]
    model = load_npz(LPIPS(), weights_path).to(device).eval()

    @torch.no_grad()
    def fn(a, b):
        a = torch.as_tensor(a, dtype=torch.float32, device=device)
        b = torch.as_tensor(b, dtype=torch.float32, device=device)
        return float(model(a[None] * 2.0 - 1.0, b[None] * 2.0 - 1.0)[0])

    _cached = ((weights_path, device), fn)
    return fn
