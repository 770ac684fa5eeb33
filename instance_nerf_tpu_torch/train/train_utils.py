"""Parameter freezing (PyTorch counterpart of
``instance_nerf_tpu.train.train_utils``).

The JAX package wraps its optimizer in ``optax.multi_transform`` with
``set_to_zero`` for the frozen subtrees. Here the split is by name: the
optimizer is built over the trained parameters only, so a frozen one gets
no update and no weight decay, and its gradient does not count in the
global norm that the clip takes (the JAX clip sits inside the "train"
transform).
"""
from __future__ import annotations

import torch.nn as nn


def partition_optimizer(model: nn.Module, frozen_prefixes=("backbone",)):
    """``(trained, frozen)`` lists of ``(name, parameter)``: a parameter is
    frozen when any module name on its path is one of ``frozen_prefixes``."""
    trained, frozen = [], []
    for name, p in model.named_parameters():
        path = name.split(".")[:-1]
        (frozen if any(pref in path for pref in frozen_prefixes) else trained).append((name, p))
    return trained, frozen
