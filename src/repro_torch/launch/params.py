"""Parameter accounting without allocation (port of
``repro.launch.params``): the parameter tree on the meta device, where the
reference uses ``jax.eval_shape`` over ``init``."""
from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as lm
from repro_torch.optim.adamw import tree_leaves


def param_shapes(cfg: ArchConfig):
    """The parameter tree as meta tensors (shapes and dtypes only)."""
    return lm.init(cfg, None, device="meta")


def count_params(cfg: ArchConfig) -> int:
    return sum(math.prod(x.shape) for _, x in tree_leaves(param_shapes(cfg)))


def param_bytes(cfg: ArchConfig) -> int:
    return sum(math.prod(x.shape) * x.element_size()
               for _, x in tree_leaves(param_shapes(cfg)))
