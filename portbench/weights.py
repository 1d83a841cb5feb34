"""A cell's weights, made on the device from the run's seed.

The benchmark, not the program, makes the weights: both the port and the
reference are handed the same tensors.  The tree has the layout that
``repro_torch.models.model`` reads (its ``init`` on the meta device gives
the shapes and dtypes); the values come from one ``torch.Generator`` on
the card in two large calls, a normal draw for every bf16 leaf and a
uniform draw for every f32 leaf, each leaf a view into its buffer that
starts on a 256-byte boundary (K1 takes its tensor-core variant only for
rows on 16 bytes).  Each leaf is then scaled by the rule of its name:

* norm ``scale``s, stacked over layers or not: 1 + N(0, 0.01);
* dense weights ``w``, ``lora_a``, ``conv_w`` and any other leaf of two
  or more dims: N(0, 1 / fan_in), fan_in the second-to-last dim;
* the embedding ``table``: N(0, 1 / d_model);
* other 1-D bf16 leaves: 1 + N(0, 0.01);
* ``lora_b``: N(0, 0.02^2), non-zero so that the LoRA merge matters;
* biases ``b``, ``bias``, ``conv_b``: N(0, 0.02^2) / N(0, 0.01);
* Mamba2's f32 leaves as the Mamba2 paper initialises them: ``a_log`` =
  log U(1, 16), ``dt_bias`` the inverse softplus of a log-uniform step in
  [0.001, 0.1], ``d_skip`` U(0.5, 1.5).

Norm scales are ruled by their name, not by their number of dims: the
stack keeps one row of scales per layer, and drawn as dense weights
(zero mean, spread 1 / sqrt(layers)) they turned the hidden states of
every position towards one direction, so that greedy decoding repeated
one token whatever the context.  Drawn near 1, the reference's decode
tokens follow the context (``tests/test_reference.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN = 128         # elements: 256 bytes of bf16


def _leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, path + (k,))
        else:
            out.append((path + (k,), v))
    return out


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _fill_normal(name: str, v: torch.Tensor) -> None:
    if name == "scale":
        v.mul_(0.1).add_(1.0)
    elif name in ("b", "bias", "lora_b"):
        v.mul_(0.02)
    elif name == "conv_b":
        v.mul_(0.1)
    elif name == "table":
        v.mul_(v.shape[-1] ** -0.5)
    elif v.dim() >= 2:
        v.mul_(v.shape[-2] ** -0.5)
    else:
        v.mul_(0.1).add_(1.0)


def _fill_uniform(name: str, v: torch.Tensor) -> None:
    if name == "scale":
        v.sub_(0.5).mul_(0.2).add_(1.0)
    elif name == "a_log":
        v.mul_(15.0).add_(1.0).log_()
    elif name == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(v * (hi - lo) + lo)
        v.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif name == "d_skip":
        v.add_(0.5)
    elif v.dim() >= 2:
        v.mul_(2.0).sub_(1.0).mul_(math.sqrt(3.0) * v.shape[-2] ** -0.5)
    else:
        v.sub_(0.5).mul_(0.2).add_(1.0)


def make(meta: Dict, seed: int, device) -> Dict:
    """A tree shaped like ``meta`` (tensors on the meta device) with
    values drawn from ``seed`` on ``device``."""
    leaves = _leaves(meta)
    for _, v in leaves:
        if v.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"no rule for a {v.dtype} leaf")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict = {}
    for dtype, draw, fill in ((torch.bfloat16, torch.randn, _fill_normal),
                              (torch.float32, torch.rand, _fill_uniform)):
        mine = [(p, v) for p, v in leaves if v.dtype == dtype]
        offsets, total = [], 0
        for _, v in mine:
            offsets.append(total)
            total += -(-v.numel() // ALIGN) * ALIGN
        if not total:
            continue
        buf = draw(total, generator=gen, device=device, dtype=dtype)
        for (path, v), off in zip(mine, offsets):
            leaf = buf[off:off + v.numel()].view(v.shape)
            fill(path[-1], leaf)
            _set(out, path, leaf)
    return out
