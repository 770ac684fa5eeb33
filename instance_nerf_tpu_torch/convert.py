"""flax params tree (numpy leaves) -> a state dict of the port's
``NeRF_RCNN``, ``NeRFRegionProposalNetwork``, ``FCOSOverNeRF``,
``InstanceNGP`` or ``InstanceNGPFast``, or of a fleet of fields (a stacked
tree, ``fleet_params_from_jax``).

Mappings:

* conv kernel DHWIO -> OIDHW;
* Dense kernel ``(in, out)`` -> ``(out, in)``; ``fc6`` takes the pooled
  ``(5, 5, 5, C)`` features flattened channels-last in both packages, so
  its columns need no permutation;
* GroupNorm and LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
* the Swin attention's ``rel_pos_bias_table`` carries over as it is (its
  ``patch_embed`` is a 5-D conv kernel like any other);
* ``ConvTranspose`` (``conv5_mask``) kernel DHWIO -> ``(I, O, D, H, W)``
  **flipped spatially**: flax's ``nn.ConvTranspose`` (``transpose_kernel=
  False``) with k2 s2 SAME computes ``y[2i + a] = x[i] k[1 - a]`` where
  ``torch.nn.functional.conv_transpose3d`` computes ``x[i] w[a]``;
* the field's tables (``hash_table``, ``brick_table``, ``dense_grid``)
  and FCOS's per-level ``head/scales`` carry over as they are;
* module names: ``FPN_0`` -> ``fpn``, ``Conv_0`` -> ``conv``,
  ``GroupNorm_0`` -> ``norm``; every other name is kept.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_RENAME = {"FPN_0": "fpn", "Conv_0": "conv", "GroupNorm_0": "norm"}
_TRANSPOSED = {"conv5_mask"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def unflatten_npz(flat: Mapping[str, np.ndarray]) -> dict:
    """``{"params/backbone/stem/Conv_0/kernel": arr, ...}`` -> nested dict."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return tree


def rcnn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """Convert a flax ``NeRF_RCNN`` params tree (``{"params": {...}}`` or its
    inner dict, numpy or array-like leaves) to a ``state_dict``."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    out = {}
    for path, arr in _leaves(params):
        mods, leaf = path[:-1], path[-1]
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":
            if mods[-1] in _TRANSPOSED:
                arr = arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("bias", "rel_pos_bias_table"):
            name = leaf
        else:
            raise ValueError(f"unexpected param {'/'.join(path)}")
        key = ".".join([_RENAME.get(m, m) for m in mods] + [name])
        out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out


def rpn_params_from_jax(params) -> dict[str, torch.Tensor]:
    """Convert a flax ``NeRFRegionProposalNetwork`` params tree to a
    ``state_dict``: the backbone as for ``NeRF_RCNN``, and the head's
    ``rpn_head/conv_i``, ``cls_logits`` and ``bbox_pred`` as plain 5-D
    convs (the same leaf mapping)."""
    return rcnn_params_from_jax(params)


def fcos_params_from_jax(params) -> dict[str, torch.Tensor]:
    """Convert a flax ``FCOSOverNeRF`` params tree to a ``state_dict``: the
    backbone and the head's towers, GroupNorms and output convs as for
    ``NeRF_RCNN``, and ``head/scales`` (one f32 a level) as ``head.scales``."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    head = dict(params["head"])
    scales = torch.tensor(np.asarray(head.pop("scales"), np.float32))
    out = rcnn_params_from_jax({**params, "head": head})
    out["head.scales"] = scales
    return out


FIELD_TABLES = ("hash_table", "brick_table", "dense_grid")


def ngp_params_from_jax(params) -> dict[str, torch.Tensor]:
    """Convert a flax ``InstanceNGP`` / ``InstanceNGPFast`` params tree to a
    ``state_dict``: the tables as they are, each ``Dense`` (``sigma_0`` ...
    ``inst_1``) as ``weight (out, in)`` and ``bias``."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    tables = {k: torch.tensor(np.asarray(params[k], np.float32))
              for k in FIELD_TABLES if k in params}
    rest = {k: v for k, v in params.items() if k not in FIELD_TABLES}
    return {**tables, **rcnn_params_from_jax(rest)}


def fleet_params_from_jax(params) -> dict[str, torch.Tensor]:
    """Convert a stacked flax fleet tree (``init_multiscene_params``: every
    leaf with a leading ``(B,)`` scene axis) to a ``state_dict`` of the
    port's fleet field (``build_model(cfg, n_scenes=B)``): each scene as
    ``ngp_params_from_jax`` converts it, stacked on the scene axis."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    leaves = dict(_leaves(params))
    b = next(iter(leaves.values())).shape[0]

    def scene(i):
        tree: dict = {}
        for path, arr in leaves.items():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = arr[i]
        return ngp_params_from_jax(tree)

    scenes = [scene(i) for i in range(b)]
    return {k: torch.stack([s[k] for s in scenes]) for k in scenes[0]}
