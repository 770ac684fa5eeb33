"""Plain reference of ``toy_conv``, a configuration of the tests alone
(``test_bench_foreign_cell.py`` installs this module as
``benchmark.reference.toy_conv``): a Conv3d, tanh, 1x1x1 Conv3d model
trained on a mean squared error by a hand-written Adam.

Besides ``readings`` it makes the inputs both sides get (``inputs``: the
weights and each step's batch, from the seed) and brings a number of its
own (``gaps``: ``out_gap``, the model's output on the first batch after
the first call, against the reference's)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RECORDED_STEPS = 3


def inputs(cfg: dict, traffic: dict, seed: int, device) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """``(params, x, y)`` from ``seed``: the weights, named as the program's
    ``nn.Sequential`` names them, and each step's batch, ``(steps, B, C,
    S, S, S)`` and ``(steps, B, 1, S, S, S)``."""
    g = torch.Generator(device=device).manual_seed(seed)
    c, h, s = cfg["channels"], cfg["hidden"], traffic["size"]
    lead = (traffic["steps_per_call"], traffic["batch"])

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    params = {"0.weight": draw(h, c, 3, 3, 3, scale=(c * 27) ** -0.5),
              "0.bias": draw(h, scale=0.1),
              "2.weight": draw(1, h, 1, 1, 1, scale=h ** -0.5),
              "2.bias": draw(1, scale=0.1)}
    return params, draw(*lead, c, s, s, s), draw(*lead, 1, s, s, s)


def forward(params: dict, x: torch.Tensor, precision=None) -> torch.Tensor:
    """The model; ``precision="bf16"`` rounds each convolution's operands
    to bfloat16 (the control)."""
    low = (lambda t: t.bfloat16().float()) if precision == "bf16" else (lambda t: t)
    h = torch.tanh(F.conv3d(low(x), low(params["0.weight"]), params["0.bias"], padding=1))
    return F.conv3d(low(h), low(params["2.weight"]), params["2.bias"])


def leaf_norms(tensors: dict) -> dict:
    return {k: [float(torch.linalg.vector_norm(v.detach().double()))] for k, v in tensors.items()}


def readings(cfg: dict, traffic: dict, seed: int, device, precision=None, fault=None,
             seen=None) -> dict:
    """The first call's readings: the first three losses, the first
    gradient's and the three steps' change's norm per leaf, and the output
    on the first batch after the call. ``fault="half_batch"`` trains on the
    first half of each batch."""
    del seen  # the program makes no inputs of its own
    params, x, y = inputs(cfg, traffic, seed, device)
    probe = x[0]
    if fault == "half_batch":
        x, y = x[:, : x.shape[1] // 2], y[:, : y.shape[1] // 2]
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    initial = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad, change = [], None, None
    for t in range(traffic["steps_per_call"]):
        loss = torch.mean((forward(params, x[t], precision) - y[t]) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, p), gr in zip(params.items(), grads):
                mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * gr
                nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * gr * gr
                mhat = mu[k] / (1 - ADAM_B1 ** (t + 1))
                vhat = nu[k] / (1 - ADAM_B2 ** (t + 1))
                p -= cfg["lr"] * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        if t < RECORDED_STEPS:
            losses.append(float(loss.detach()))
        if t == 0:
            grad = leaf_norms(dict(zip(params, grads)))
        if t == RECORDED_STEPS - 1:
            change = leaf_norms({k: p - initial[k] for k, p in params.items()})
    with torch.no_grad():
        out = forward(params, probe, precision)
    return {"loss": losses, "grad": grad, "change": change, "out": out.cpu()}


def gaps(prog: dict, ref: dict) -> dict:
    """``out_gap``: the largest gap of the two outputs over the reference's
    largest magnitude."""
    p, r = prog["out"].double(), ref["out"].double()
    if p.shape != r.shape:
        raise ValueError("the two sides' outputs differ in shape")
    return {"out_gap": float((p - r).abs().max() / r.abs().max())}
