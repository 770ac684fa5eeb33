"""Metrics logging: JSONL always, wandb when available and requested
(a copy of ``instance_nerf_tpu.utils.logging``, which imports no JAX).

Per-rank python logging is plain ``logging``; the optional ``--wandb`` path
(config, per-step losses / lr, eval metrics) is kept where the package is
importable, with a JSONL metrics file as the always-on substitute.
"""
from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, save_path: str | None = None, use_wandb: bool = False,
                 config: dict | None = None, project: str = "instance_nerf_tpu"):
        self._file = None
        self._wandb = None
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            self._file = open(os.path.join(save_path, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, config=config or {})
            except Exception:
                self._wandb = None  # wandb not installed / no network

    def log(self, metrics: dict, step: int | None = None):
        rec = {"time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        if step is not None:
            rec["step"] = int(step)
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()
