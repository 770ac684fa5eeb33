"""Entry ``toy_train`` of the tests alone (``test_bench_foreign_cell.py``
installs this module as ``benchmark.entries.toy_train``): a training cell
that is not a field. The program side is a plain PyTorch Conv3d model
trained by ``torch.optim.Adam`` under the port's ``Stages("toy_train")``,
with spans ``forward``, ``loss``, ``backward`` and ``optimizer``; the step
span is ``optimizer``.

Set-up draws the weights and the batches from the seed
(``toy_reference.inputs``), runs the first call with its readings
recorded, then one more call; the window calls ``steps_per_call`` steps
over the same batches. ``planted("altered_output")`` alters the model's
prediction (its output outside training) where it is produced, which the
configuration's own number (``out_gap``) alone reads.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from benchmark.tests import toy_reference

REFERENCE_FAULTS = ("half_batch",)
FAULTS = ("altered_output",)


class ToyModel(torch.nn.Sequential):
    def __init__(self, channels: int, hidden: int):
        super().__init__(torch.nn.Conv3d(channels, hidden, 3, padding=1), torch.nn.Tanh(),
                         torch.nn.Conv3d(hidden, 1, 1))


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` planted in the program while the block runs: the model's
    prediction off by 1%, its training untouched."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    inner = ToyModel.forward

    def altered(self, x):
        out = inner(self, x)
        return out if torch.is_grad_enabled() else out * 1.01

    ToyModel.forward = altered
    try:
        yield
    finally:
        del ToyModel.forward


class ToySession:
    prefix = "toy_train"
    step_span = "optimizer"
    work_unit = "samples"
    flops_per_call = None

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from instance_nerf_tpu_torch.train.timing import Stages

        params, self.x, self.y = toy_reference.inputs(cfg, traffic, seed, device)
        self.model = ToyModel(cfg["channels"], cfg["hidden"]).to(device)
        self.model.load_state_dict(params, strict=True)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg["lr"],
                                    betas=(toy_reference.ADAM_B1, toy_reference.ADAM_B2),
                                    eps=toy_reference.ADAM_EPS)
        self.stage = Stages(self.prefix)
        self.steps_per_call = traffic["steps_per_call"]
        self._readings = self._first_call()
        self.call()

    def _step(self, t: int) -> torch.Tensor:
        with self.stage("forward"):
            out = self.model(self.x[t])
        with self.stage("loss"):
            loss = F.mse_loss(out, self.y[t])
        with self.stage("backward"):
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        with self.stage("optimizer"):
            self.opt.step()
        return loss.detach()

    def _first_call(self) -> dict:
        names = dict(self.model.named_parameters())
        initial = {k: p.detach().clone() for k, p in names.items()}
        losses, grad, change = [], None, None
        for t in range(self.steps_per_call):
            loss = self._step(t)
            if t < toy_reference.RECORDED_STEPS:
                losses.append(float(loss))
            if t == 0:  # the gradient as Adam got it: its first moment over 1 - b1
                grad = toy_reference.leaf_norms(
                    {k: self.opt.state[p]["exp_avg"] / (1 - toy_reference.ADAM_B1)
                     for k, p in names.items()})
            if t == toy_reference.RECORDED_STEPS - 1:
                change = toy_reference.leaf_norms({k: p - initial[k] for k, p in names.items()})
        with torch.no_grad():
            out = self.model(self.x[0])
        return {"loss": losses, "grad": grad, "change": change, "out": out.cpu()}

    def call(self) -> tuple[int, bool]:
        loss = None
        for t in range(self.steps_per_call):
            loss = self._step(t)
        return self.steps_per_call * self.x.shape[1], math.isfinite(float(loss))

    def readings(self) -> dict:
        return self._readings

    def close(self) -> None:
        self.model = self.opt = None


def setup(ctx) -> ToySession:
    return ToySession(ctx.config, ctx.traffic, ctx.seed, ctx.device)
