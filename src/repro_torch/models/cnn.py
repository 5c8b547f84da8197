"""The paper's FL payload models (Section VI-A), in plain PyTorch.

- MNIST:  CNN with two conv layers and two fully connected layers.
- FMNIST: CNN with two conv layers and one fully connected layer.
- CIFAR-10: VGG-11.

Params are nested dicts of tensors in the reference's nesting (VGG-11
keeps ``params["convs"]`` as a list); ``apply(params, x)`` returns
logits.  The public layout is the reference's: ``x`` is NHWC.  Inside,
the convolutions run NCHW with OIHW kernels (``convert.params_from_jax``
carries HWIO kernels across), and activations are permuted back to NHWC
before they are flattened, so the dense weights keep the reference's
row order.  3x3 SAME convolution is ``padding=1``; max-pooling is VALID
2x2 (``max_pool2d`` floors).

Init draws from a CPU ``torch.Generator`` and then moves to the device,
so one seed gives the same initial model on the CPU and on the card.  It
cannot reproduce ``jax.random``: parity with the reference goes through
``repro_torch.convert``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_leaves, tree_map


def _conv_init(gen, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    std = math.sqrt(2.0 / fan_in)
    return {"w": torch.randn((cout, cin, kh, kw), generator=gen) * std,
            "b": torch.zeros((cout,))}


def _dense_init(gen, din, dout):
    std = math.sqrt(2.0 / din)
    return {"w": torch.randn((din, dout), generator=gen) * std,
            "b": torch.zeros((dout,))}


def _conv(x, p):
    return F.conv2d(x, p["w"], p["b"], padding=1)


def _flatten_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# MNIST CNN: conv(32) -> pool -> conv(64) -> pool -> fc(128) -> fc(10)
# ---------------------------------------------------------------------------
def init_mnist_cnn(gen, image_shape=(28, 28, 1), n_classes=10) -> Dict:
    h, w, c = image_shape
    flat = (h // 4) * (w // 4) * 64
    return {"c1": _conv_init(gen, 3, 3, c, 32),
            "c2": _conv_init(gen, 3, 3, 32, 64),
            "f1": _dense_init(gen, flat, 128),
            "f2": _dense_init(gen, 128, n_classes)}


def apply_mnist_cnn(params, x):
    x = x.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["c1"])), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["c2"])), 2)
    x = _flatten_nhwc(x)
    x = F.relu(x @ params["f1"]["w"] + params["f1"]["b"])
    return x @ params["f2"]["w"] + params["f2"]["b"]


# ---------------------------------------------------------------------------
# FMNIST CNN: conv(16) -> pool -> conv(32) -> pool -> fc(10)
# ---------------------------------------------------------------------------
def init_fmnist_cnn(gen, image_shape=(28, 28, 1), n_classes=10) -> Dict:
    h, w, c = image_shape
    flat = (h // 4) * (w // 4) * 32
    return {"c1": _conv_init(gen, 3, 3, c, 16),
            "c2": _conv_init(gen, 3, 3, 16, 32),
            "f1": _dense_init(gen, flat, n_classes)}


def apply_fmnist_cnn(params, x):
    x = x.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["c1"])), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["c2"])), 2)
    x = _flatten_nhwc(x)
    return x @ params["f1"]["w"] + params["f1"]["b"]


# ---------------------------------------------------------------------------
# VGG-11 for CIFAR-10
# ---------------------------------------------------------------------------
_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def init_vgg11(gen, image_shape=(32, 32, 3), n_classes=10) -> Dict:
    params = {"convs": [], "fc": None}
    cin = image_shape[2]
    for v in _VGG11:
        if v == "M":
            continue
        params["convs"].append(_conv_init(gen, 3, 3, cin, v))
        cin = v
    params["fc"] = _dense_init(gen, 512, n_classes)
    return params


def apply_vgg11(params, x):
    x = x.permute(0, 3, 1, 2)
    ci = 0
    for v in _VGG11:
        if v == "M":
            x = F.max_pool2d(x, 2)
        else:
            x = F.relu(_conv(x, params["convs"][ci]))
            ci += 1
    x = _flatten_nhwc(x)
    return x @ params["fc"]["w"] + params["fc"]["b"]


# ---------------------------------------------------------------------------
MODELS: Dict[str, Tuple[Callable, Callable]] = {
    "mnist": (init_mnist_cnn, apply_mnist_cnn),
    "fmnist": (init_fmnist_cnn, apply_fmnist_cnn),
    "cifar10": (init_vgg11, apply_vgg11),
}


def build_model(name: str, seed: int, device: torch.device,
                image_shape=None, n_classes=10):
    """``(params, apply)`` for model ``name``, initialized from ``seed``
    on the CPU and moved to ``device``."""
    init, apply = MODELS[name]
    kw = {}
    if image_shape is not None:
        kw["image_shape"] = tuple(image_shape)
    gen = torch.Generator().manual_seed(seed)
    params = tree_map(lambda t: t.to(device),
                      init(gen, n_classes=n_classes, **kw))
    return params, apply


def param_count(params) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(params))


def model_bits(params, dtype_bits: int = 32) -> float:
    """Q(w) for the latency model."""
    return float(param_count(params) * dtype_bits)
