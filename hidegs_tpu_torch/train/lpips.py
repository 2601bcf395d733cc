"""LPIPS perceptual metric (VGG16 variant) in PyTorch.

Port of hidegs_tpu/train/lpips.py, with the same architecture as the
reference's lpipsPyTorch (lpipsPyTorch/modules/lpips.py:8-36, networks.py):
VGG16 conv features at the 5 standard taps (relu1_2, relu2_2, relu3_3,
relu4_3, relu5_3), per-channel unit-normalization, 1x1 linear heads,
spatial mean, sum over taps. The JAX package runs the convolutions as XLA
convolutions at full float32 precision; here they are
`torch.nn.functional.conv2d` with TF32 off (hidegs_tpu_torch/__init__.py).

Parameters are a dict of tensors keyed as the JAX package's (`conv{i}_w`,
`conv{i}_b`, `lin{j}_w`), so the .npz files that its `convert_torch_weights`
writes load here unchanged ("calibrated-vgg"). Without one,
`default_lpips_fn` falls back to a deterministic seeded-random VGG16
("random-vgg"): a documented baseline (Zhang et al. 2018, Table 5) that is
useful for comparing checkpoints of one run but not comparable to
calibrated LPIPS numbers, which is why every report carries `lpips_kind`.
The random weights are drawn from a seeded numpy generator: they are not
the JAX package's `jax.random.PRNGKey(0)` draws, so random-vgg values differ
between the two packages (ROADMAP C6); carried across with
`convert.lpips_params_from_jax`, the same weights give the same distance.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from hidegs_tpu_torch.device import DeviceLike, resolve_device

# VGG16 conv layout: (out_channels, num_convs) per block
VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# ImageNet normalization used by LPIPS "scaling layer"
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

Params = Dict[str, torch.Tensor]


def vgg16_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (N, 3, H, W); returns the 5 tap activations."""
    taps = []
    i = 0
    for bi, (_, n_convs) in enumerate(VGG16_BLOCKS):
        for _ in range(n_convs):
            x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"], padding=1))
            i += 1
        taps.append(x)
        if bi < len(VGG16_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


@functools.lru_cache(maxsize=None)
def _scaling_layer(device: torch.device):
    """(SHIFT, SCALE) as (3, 1, 1) tensors on `device`, copied there once:
    a copy per call would make the host wait for the device per view."""
    return (torch.as_tensor(SHIFT, device=device)[:, None, None],
            torch.as_tensor(SCALE, device=device)[:, None, None])


def lpips_distance(params: Params, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """img: (3, H, W) in [0, 1] → scalar LPIPS."""
    shift, scale = _scaling_layer(img1.device)

    def prep(img):
        x = img * 2.0 - 1.0  # [0,1] → [-1,1] (lpips convention)
        return ((x - shift) / scale)[None]

    f1 = vgg16_features(params, prep(img1))
    f2 = vgg16_features(params, prep(img2))
    total = torch.zeros((), dtype=torch.float32, device=img1.device)
    for i, (a, b) in enumerate(zip(f1, f2)):
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
        b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
        diff = (a - b) ** 2
        total = total + torch.mean(torch.sum(diff * params[f"lin{i}_w"], dim=1))
    return total


def params_to_device(arrays: Dict[str, np.ndarray], device: DeviceLike = "cuda") -> Params:
    """A parameter dict of numpy arrays → float32 tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev) for k, v in arrays.items()}


def _fn(params: Params) -> Callable:
    def lpips(a, b):
        with torch.no_grad():
            return lpips_distance(params, a, b)

    return lpips


def load_lpips(npz_path: str, device: DeviceLike = "cuda") -> Callable:
    """Load converted weights → lpips(img1, img2) callable on `device`."""
    with np.load(npz_path) as data:
        return _fn(params_to_device({k: data[k] for k in data.files}, device))


def default_lpips_fn(npz_path: str = "", device: DeviceLike = "cuda") -> tuple:
    """Best-available LPIPS callable → (fn, kind-label).

    kind = "calibrated-vgg" when a converted weight file is given, else
    "random-vgg" (seeded, deterministic across runs; see the module
    docstring for what that does and does not mean).
    """
    if npz_path:
        return load_lpips(npz_path, device), "calibrated-vgg"
    return _fn(random_lpips_params(0, device)), "random-vgg"


def random_lpips_params(seed: int = 0, device: DeviceLike = "cuda") -> Params:
    """Deterministic random-weight instance: conv weights N(0, 1/(9·in)),
    zero biases, uniform 1/C heads, drawn from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    arrays = {}
    in_ch = 3
    i = 0
    for ch, n_convs in VGG16_BLOCKS:
        for _ in range(n_convs):
            arrays[f"conv{i}_w"] = rng.standard_normal((ch, in_ch, 3, 3)) * (1.0 / np.sqrt(in_ch * 9))
            arrays[f"conv{i}_b"] = np.zeros((ch,))
            in_ch = ch
            i += 1
    for j, (ch, _) in enumerate(VGG16_BLOCKS):
        arrays[f"lin{j}_w"] = np.ones((1, ch, 1, 1)) / ch
    return params_to_device(arrays, device)


def params_from_torch_modules(conv_modules, lin_weights=None) -> Dict[str, np.ndarray]:
    """Map torch Conv2d modules (in VGG16 feature order) + optional LPIPS
    1x1 linear-head weights to this module's parameter dict, as numpy
    arrays (`params_to_device` puts them on a device).

    `conv_modules`: the 13 VGG16 Conv2d layers in forward order.
    `lin_weights`: 5 arrays of shape (1, C, 1, 1) (the lpips package's
    `net.lins[j].model[-1].weight`); uniform 1/C heads when omitted.
    """
    n_convs = sum(n for _, n in VGG16_BLOCKS)
    if len(conv_modules) != n_convs:
        raise ValueError(f"expected {n_convs} convs, got {len(conv_modules)}")
    params: Dict[str, np.ndarray] = {}
    for i, m in enumerate(conv_modules):
        params[f"conv{i}_w"] = np.asarray(m.weight.detach().cpu().numpy(), np.float32)
        params[f"conv{i}_b"] = np.asarray(m.bias.detach().cpu().numpy(), np.float32)
    for j, (ch, _) in enumerate(VGG16_BLOCKS):
        if lin_weights is not None:
            w = np.asarray(lin_weights[j], np.float32).reshape(1, ch, 1, 1)
        else:
            w = np.full((1, ch, 1, 1), 1.0 / ch, np.float32)
        params[f"lin{j}_w"] = w
    return params


def cached_vgg16_convs() -> List[torch.nn.Conv2d]:
    """torchvision's ImageNet VGG16 conv layers (IMAGENET1K_V1, the trunk
    both sources use), loaded from torch.hub's cache. Nothing here fetches
    weights: a missing file raises FileNotFoundError naming it."""
    from torchvision.models import VGG16_Weights, vgg16

    path = os.path.join(torch.hub.get_dir(), "checkpoints", os.path.basename(VGG16_Weights.IMAGENET1K_V1.url))
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: torchvision's VGG16 ImageNet weights are not in torch.hub's cache; "
                                "put the file there (this conversion fetches nothing)")
    net = vgg16(weights=None)
    net.load_state_dict(torch.load(path, map_location="cpu"))
    return [m for m in net.features if isinstance(m, torch.nn.Conv2d)]


def convert_torch_weights(out_npz: str, source: str = "lpips") -> Dict[str, np.ndarray]:
    """Convert pretrained torch weights to the .npz `load_lpips` reads (the
    JAX package's format, so either package loads it).

    Run where the needed packages are installed and torchvision's VGG16
    ImageNet weights are in torch.hub's cache (none of them is a
    dependency of this repository, and nothing here fetches weights):
      * source="lpips": the `lpips` pip package's calibrated VGG LPIPS
        (its linear heads, which the package ships, on torchvision's
        trunk), the reference's exact metric
        (lpipsPyTorch/modules/lpips.py:8-36);
      * source="torchvision": torchvision's ImageNet VGG16 trunk with
        uniform heads (uncalibrated).
    """
    if source == "lpips":
        import lpips as lpips_pkg

        convs = cached_vgg16_convs()
        # pnet_rand: a trunk of random weights in place of the fetched one
        # (the convs above take its place); the heads load from the package
        net = lpips_pkg.LPIPS(net="vgg", pnet_rand=True)
        lins = [lin.model[-1].weight.detach().cpu().numpy() for lin in net.lins]
        params = params_from_torch_modules(convs, lins)
    elif source == "torchvision":
        params = params_from_torch_modules(cached_vgg16_convs())
    else:
        raise ValueError(f"unknown source {source!r}")
    np.savez(out_npz, **params)
    return params


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=convert_torch_weights.__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--source", default="lpips", choices=["lpips", "torchvision"])
    a = p.parse_args(argv)
    params = convert_torch_weights(a.out, a.source)
    print(f"wrote {len(params)} arrays to {a.out}")


if __name__ == "__main__":
    main()
