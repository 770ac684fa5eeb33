"""Model FLOPs of one call by the JAX package's rule: a frozen copy of the
port's ``utils/flops.py:count_flops`` (kept here so that a later change to
the program cannot move the yardstick).

The JAX counter walks a traced program and counts its matmuls and
convolutions, forward and backward alike, as 2 x multiply-adds; grouped
convolutions divide by the groups; elementwise work is left out. Here the
call runs once under ``torch.utils.flop_counter.FlopCounterMode``, which
sees each matmul and convolution that autograd runs, the backward's too,
with the JAX rule registered for the two convolution ops (a convolution
over the spatial size of what it writes, with the whole kernel).
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten


def _conv(x_shape, w_shape, _bias, _stride, _padding, _dilation, _transposed, *args,
          out_shape=None, **kwargs) -> int:
    """A forward convolution: over the output's spatial size."""
    return 2 * x_shape[0] * math.prod(w_shape) * math.prod(out_shape[2:])


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                   _transposed, _output_padding, _groups, output_mask, out_shape=None,
                   **kwargs) -> int:
    """The input gradient over the input's spatial size, the weight gradient
    over the forward output's (the bias gradient is a sum: not counted)."""
    per = 2 * x_shape[0] * math.prod(w_shape)
    flops = 0
    if output_mask[0]:
        flops += per * math.prod(x_shape[2:])
    if output_mask[1]:
        flops += per * math.prod(grad_out_shape[2:])
    return flops


def _mv(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


JAX_RULES = {aten.convolution: _conv, aten.convolution_backward: _conv_backward,
             aten.mv: _mv, aten.dot: _dot}


def count_flops(fn, *args, **kwargs) -> float:
    """Matmul and convolution FLOPs of one call of ``fn(*args, **kwargs)``
    (which runs once). Pass the step you time, backward and optimizer
    included: the count covers forward and backward alike."""
    with FlopCounterMode(display=False, custom_mapping=JAX_RULES) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
