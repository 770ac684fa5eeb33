"""Checkpoints with the train config embedded (PyTorch counterpart of
``instance_nerf_tpu.train.checkpoints``, torch-native: the JAX package's
orbax layout is not read; a flax params ``.npz`` loads through
``convert.py``).

Layout under the manager's directory: ``step_<N>/state.pt`` (a
``torch.save`` of ``{"params", "opt_state", "step"}`` or of any dict of
tensors, numbers and lists) and ``step_<N>/meta.json`` (step, the config as
JSON, the metrics), written last: it marks the checkpoint committed, so a
save cut off mid-write is never offered for restore. ``best/`` holds hard
links to the files of the checkpoint with the highest ``best_metric``. The
newest ``keep`` steps are kept.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from instance_nerf_tpu_torch.convert import unflatten_npz


def _jsonable(v):
    """Metric values may be scalars or structured (per-class AP lists with
    Nones): keep JSON-native values, numbers and 0-dim tensors as floats."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return float(v)


class CheckpointManager:
    """Step-indexed checkpoints under ``directory/step_N`` and
    ``directory/best``."""

    def __init__(self, directory: str, keep: int = 2, best_metric: str | None = None):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self.best_metric = best_metric
        self.best_value = -float("inf")
        best_meta = os.path.join(self.dir, "best", "meta.json")
        if os.path.isfile(best_meta):  # the best so far survives a restart
            with open(best_meta) as f:
                self.best_value = json.load(f).get("metric_value", -float("inf"))

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: dict, config: dict | None = None,
             metrics: dict | None = None) -> None:
        path = os.path.join(self.dir, f"step_{step}")
        self._write(path, state, config, metrics, step)
        self._retain()
        if self.best_metric and metrics and self.best_metric in metrics:
            v = float(metrics[self.best_metric])
            if v > self.best_value:
                self.best_value = v
                best = os.path.join(self.dir, "best")
                if os.path.isdir(best):
                    shutil.rmtree(best)
                # hard links: ``best`` costs no space while its step is kept
                shutil.copytree(path, best, copy_function=os.link)

    def _write(self, path, state, config, metrics, step):
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(state, os.path.join(path, "state.pt"))
        meta = {"step": step, "config": _jsonable(config or {}),
                "metrics": {k: _jsonable(v) for k, v in (metrics or {}).items()}}
        if self.best_metric and metrics and self.best_metric in metrics:
            meta["metric_value"] = float(metrics[self.best_metric])
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def _retain(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- load ---------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """The committed steps (those with a ``meta.json``), ascending."""
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.isfile(os.path.join(self.dir, d, "meta.json")):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step, best):
        if best:
            return os.path.join(self.dir, "best")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return os.path.join(self.dir, f"step_{step}")

    def restore_any(self, step: int | None = None, best: bool = False,
                    map_location=None) -> tuple[Any, dict]:
        """(state, meta) of a step (the latest by default) or of ``best``, as
        saved: e.g. to graft a backbone across models."""
        path = self._path(step, best)
        state = torch.load(os.path.join(path, "state.pt"), map_location=map_location,
                           weights_only=True)
        with open(os.path.join(path, "meta.json")) as f:
            return state, json.load(f)

    def restore(self, state_template: dict, step: int | None = None, best: bool = False,
                map_location=None) -> tuple[Any, dict]:
        """``restore_any``, checked against ``state_template``: the same keys,
        and tensors of the same shapes in its ``params``."""
        state, meta = self.restore_any(step, best, map_location)
        if sorted(state) != sorted(state_template):
            raise ValueError(f"checkpoint keys {sorted(state)} != {sorted(state_template)}")
        want, got = state_template.get("params"), state.get("params")
        if want is not None:
            shapes = {k: tuple(v.shape) for k, v in want.items()}
            if {k: tuple(v.shape) for k, v in got.items()} != shapes:
                raise ValueError("checkpoint params differ from the template's")
        return state, meta


def load_embedded_config(ckpt_dir: str, step: int | None = None) -> dict:
    """The train config embedded in a checkpoint (the latest step's, else
    ``best``'s)."""
    mgr = CheckpointManager(ckpt_dir)
    step = step if step is not None else mgr.latest_step()
    path = os.path.join(mgr.dir, "best" if step is None else f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)["config"]


def load_params(path: str, map_location=None) -> dict:
    """A state dict's ``params`` from a checkpoint directory (the latest
    step, else ``best``), or the whole dict when it has no ``params``."""
    mgr = CheckpointManager(path)
    state, _ = mgr.restore_any(best=mgr.latest_step() is None, map_location=map_location)
    return state["params"] if "params" in state else state


def load_params_into(model, path: str, from_jax) -> None:
    """Load ``model``'s parameters from ``path``: a checkpoint directory of
    the port, or a flax params tree as ``.npz`` through ``from_jax``."""
    if os.path.isdir(path):
        model.load_state_dict(load_params(path, map_location="cpu"), strict=True)
        return
    with np.load(path) as z:
        tree = unflatten_npz({k: z[k] for k in z.files})
    model.load_state_dict(from_jax(tree), strict=True)
