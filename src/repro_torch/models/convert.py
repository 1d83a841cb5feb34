"""Parameters of the JAX reference, as numpy arrays, into the port.

The port keeps the reference's parameter tree and layouts (layer-stacked
leaves with a leading L axis under ``stack/dense_stack``, dense weights
``(d_in, d_out)``), so the conversion map is the identity on paths: every
leaf is copied, after its path and shape are checked against the port's
own ``init`` on the meta device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as lm


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` pairs of a nested dict, paths joined by '/'."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], path)
        else:
            yield path, tree[k]


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # numpy has no native bf16
        arr = arr.astype(np.float32)
    # np.array copies: the source may be a read-only view of a JAX buffer
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def params_from_jax(np_tree: Dict, cfg: ArchConfig, device=None) -> Dict:
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters on ``device``; raises on any missing, extra or misshapen
    leaf."""
    device = lm.resolve_device(device)
    want = dict(leaves(lm.init(cfg, device="meta")))
    got = dict(leaves(np_tree))
    if set(want) != set(got):
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    out: Dict = {}
    for path, ref in want.items():
        arr = got[path]
        if tuple(np.shape(arr)) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {np.shape(arr)} != "
                             f"{tuple(ref.shape)}")
        node = out
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = _tensor(arr, ref.dtype, device)
    return out
