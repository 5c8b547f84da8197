"""Initial weights and inputs, made by the benchmark from ``--seed``.

Both sides get the same: the program is handed these tensors (it copies
them), and the reference makes them again from the same seed after the
window.  Every random number comes from one ``torch.Generator`` on the
device, in one large draw a tree, and is carved into leaves.  The scales
are torchvision's VGG init for the CNN and, for the transformer,
``1/sqrt(fan_in)`` with a unit embedding and depth-scaled residual
outputs; the numbers are the benchmark's own.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator for ``seed`` (any whole number; folded to 63 bits) and
    one of its independent ``stream`` s."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 7919 * int(stream))
                  % (2 ** 63 - 1))
    return g


def _carve(shapes: List[Tuple[Tuple[int, ...], float, torch.dtype]],
           gen: torch.Generator, device) -> List[torch.Tensor]:
    """One normal draw for every leaf of ``shapes`` ((shape, std,
    dtype)), each leaf its own scaled copy of a slice."""
    total = sum(math.prod(s) for s, _, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = [], 0
    for shape, std, dtype in shapes:
        n = math.prod(shape)
        out.append((flat[off:off + n].view(shape) * std).to(dtype))
        off += n
    del flat
    return out


def vgg11(seed: int, device, image_shape=(32, 32, 3),
          n_classes: int = 10) -> Dict:
    """VGG-11's params in the program's tree: ``convs`` (OIHW kernels and
    biases) and ``fc``, float32, with torchvision's VGG init: He normal
    over the fan-out for the convolutions, N(0, 0.01) for the dense
    layer, zero biases (the configuration says why not the port's)."""
    shapes, cin = [], image_shape[2]
    for v in VGG11:
        if v == "M":
            continue
        shapes.append(((v, cin, 3, 3), math.sqrt(2.0 / (9 * v)),
                       torch.float32))
        cin = v
    shapes.append(((cin, n_classes), 0.01, torch.float32))
    ws = _carve(shapes, generator(seed, device), device)
    convs = [{"w": w, "b": torch.zeros(w.shape[0], device=device)}
             for w in ws[:-1]]
    return {"convs": convs,
            "fc": {"w": ws[-1], "b": torch.zeros(n_classes, device=device)}}


def vgg11_param_count(image_shape=(32, 32, 3), n_classes: int = 10) -> int:
    n, cin = 0, image_shape[2]
    for v in VGG11:
        if v != "M":
            n += v * cin * 9 + v
            cin = v
    return n + cin * n_classes + n_classes


def rwkv6(model: dict, seed: int, device) -> Dict:
    """An RWKV6 model's params in the program's tree (``blocks`` of
    ``{"sub0": {"norm1", "norm2", "mixer": {"time", "channel"}}}``,
    ``final_norm``, ``embed``, ``lm_head``): the embedding N(0, 1)
    (``nn.Embedding``'s default), matrices in the configured type with
    std ``1/sqrt(fan_in)``, the two that write into the residual stream
    (``wo``, ``wcv``) further over ``sqrt(2 n_layers)`` (GPT-2's scaled
    residual init), the bonus ``u`` in float32 with std ``1/sqrt(head
    size)``, and the program's constants (token-mix 0.5, decay bias -2,
    scales 1).  At ``1/sqrt(fan_in)`` everywhere the 24-layer backward
    is too ill-conditioned for float32 to hold its gradients."""
    d, ff, L = model["d_model"], model["d_ff"], model["n_layers"]
    vocab = ((model["vocab_size"] + 255) // 256) * 256
    dt = getattr(torch, model["param_dtype"])
    h = max(1, d // 64)
    hd = d // h
    f32 = torch.float32
    deep = math.sqrt(2 * L)
    per_layer = [("wr", (d, d), d, 1, dt), ("wk", (d, d), d, 1, dt),
                 ("wv", (d, d), d, 1, dt), ("ww", (d, d), d, 1, dt),
                 ("wg", (d, d), d, 1, dt), ("u", (h, hd), hd, 1, f32),
                 ("wo", (d, d), d, deep, dt), ("wck", (d, ff), d, 1, dt),
                 ("wcv", (ff, d), ff, deep, dt), ("wcr", (d, d), d, 1, dt)]
    shapes = [((vocab, d), 1.0, dt), ((d, vocab), 1 / math.sqrt(d), dt)]
    for _ in range(L):
        shapes += [(s, 1 / (math.sqrt(fan) * div), t)
                   for _, s, fan, div, t in per_layer]
    leaves = iter(_carve(shapes, generator(seed, device), device))
    embed, head = next(leaves), next(leaves)

    def full(n, v):
        return torch.full((n,), v, dtype=f32, device=device)

    blocks = []
    for _ in range(L):
        m = {name: next(leaves) for name, *_ in per_layer}
        time = {"mix_r": full(d, .5), "mix_k": full(d, .5),
                "mix_v": full(d, .5), "mix_w": full(d, .5),
                "mix_g": full(d, .5), "wr": m["wr"], "wk": m["wk"],
                "wv": m["wv"], "ww": m["ww"], "wg": m["wg"],
                "w_bias": full(d, -2.0), "u": m["u"], "wo": m["wo"],
                "ln_scale": full(hd, 1.0)}
        channel = {"mix_k": full(d, .5), "mix_r": full(d, .5),
                   "wck": m["wck"], "wcv": m["wcv"], "wcr": m["wcr"]}
        blocks.append({"sub0": {"norm1": {"scale": full(d, 1.0)},
                                "norm2": {"scale": full(d, 1.0)},
                                "mixer": {"time": time,
                                          "channel": channel}}})
    return {"blocks": blocks, "final_norm": {"scale": full(d, 1.0)},
            "embed": {"w": embed}, "lm_head": {"w": head}}


def token_batch(gen: torch.Generator, vocab: int, lead: Tuple[int, ...],
                seq: int, device) -> Dict[str, torch.Tensor]:
    """Random token rows: ``inputs`` and the next-token ``labels``."""
    toks = torch.randint(0, vocab, (*lead, seq + 1), generator=gen,
                         device=device, dtype=torch.int64)
    return {"inputs": toks[..., :-1].contiguous(),
            "labels": toks[..., 1:].contiguous()}
