"""Parameters of the JAX reference, as numpy arrays, into the port.

The port keeps the reference's parameter tree and layouts (layer-stacked
leaves with a leading L axis under ``stack/dense_stack`` and
``stack/moe_stack`` (MLA's ``attn/{wdq,wuq,wdkv,wkr,wuk,wuv,wo}``, the
MoE's ``moe/{router,experts,shared}``), ``stack/ssm_stack`` or the
hybrid's ``stack/groups``, ``stack/shared`` and ``stack/tail``, the MTP
head's ``mtp_proj`` and ``mtp_norm``, dense weights ``(d_in, d_out)``,
expert banks ``(E, d_in, d_out)``; audio's ``mask_emb`` and ``head``, the
VLM's untied ``head``), so the conversion
map is the identity on paths: every leaf is copied, after its path and
shape are checked against the port's own ``init`` on the meta device,
and takes that leaf's dtype (the SSM's f32 ``a_log``, ``d_skip`` and
``dt_bias`` stay f32 whatever the parameter dtype).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves as leaves


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # numpy has no native bf16
        arr = arr.astype(np.float32)
    # np.array copies: the source may be a read-only view of a JAX buffer
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _from_template(np_tree: Dict, template: Dict, device) -> Dict:
    """``np_tree``'s leaves as tensors on ``device``, each in the dtype of
    the ``template`` leaf at its path; raises on any missing, extra or
    misshapen leaf."""
    want = dict(leaves(template))
    got = dict(leaves(np_tree))
    if set(want) != set(got):
        raise ValueError(f"trees differ: missing "
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


def params_from_jax(np_tree: Dict, cfg: ArchConfig, device=None) -> Dict:
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters on ``device``; raises on any missing, extra or misshapen
    leaf."""
    return _from_template(np_tree, lm.init(cfg, device="meta"),
                          resolve_device(device))


def opt_state_from_jax(np_state: Dict, cfg: ArchConfig,
                       opt: adamw.AdamWConfig, device=None) -> Dict:
    """The reference's AdamW state (numpy leaves: ``m``, ``v``, ``step``;
    int8 moments as ``{q, s}``, factored second moments as ``{r, c}``) as
    the port's, checked leaf by leaf against ``adamw.init`` of ``cfg``'s
    parameters under ``opt``."""
    template = adamw.init(lm.init(cfg, device="meta"), opt)
    return _from_template(np_state, template, resolve_device(device))
