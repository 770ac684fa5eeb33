"""What the two field entries share: the program's configuration from the
cell's configuration file, the feed of the first call, the window's call,
and the faults ``control.py`` plants.

The set-up builds the trainer once, loads the benchmark's weights and the
start grid into it (``traffic/draws.py``), and drives it through its first
call (``train`` of ``steps_per_call`` steps, as the window calls it) with
``train_step`` and ``update_occupancy`` wrapped (``Feed``). That same
trainer then serves the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

from benchmark.counts.flops import count_flops
from benchmark.reference import plain_field
from benchmark.traffic import draws

RECORDED_STEPS = 3
# the faults control.py plants: in the reference's place (the reference's
# ``fault=``), and in the program under a run of the harness (``planted``)
REFERENCE_FAULTS = ("half_batch",)
FAULTS = ("state_unchanged", "half_batch", "altered_rays")


def ngp_config(cfg: dict):
    """The program's ``NGPConfig`` of a configuration file: its fields taken
    by name, every other key left to the benchmark."""
    from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig

    names = {f.name for f in dataclasses.fields(NGPConfig)}
    return NGPConfig(**{k: v for k, v in cfg.items() if k in names})


def leaf_norms(params: dict, n_scenes: int | None) -> dict:
    """``{name: [norm of each scene's slice]}`` (``plain_field.leaf_norms``;
    one field's parameters are one scene's)."""
    b = n_scenes or 1
    return plain_field.leaf_norms({k: v.reshape(b, -1) for k, v in params.items()})


class Feed:
    """The first call's steps and refresh, fed with the benchmark's draws.

    Each step the program's own batch ``(o, d, target rgb)``, as its ray
    data made it, is kept for ``plain_field.ray_gap`` to judge, and the step
    runs on the benchmark's batch and jitter instead (``draws.batch``; the
    instance targets stay the program's, which the rgb stage reads not). The
    wrapper keeps each of the first three steps' loss, the per-leaf norm of
    the first gradient (the Adam first moment after step 1, over ``1 -
    b1``) and, right after step 3, the per-leaf norm of the parameters'
    change. The refresh runs on the benchmark's cells and jitter, and the
    grid it leaves is kept. Then both wrappers take themselves off."""

    def __init__(self, trainer, inp: draws.Inputs, n_scenes: int | None, initial: dict,
                 read_grid):
        self.trainer, self.inp, self.n_scenes = trainer, inp, n_scenes
        self.initial, self.read_grid = initial, read_grid
        self.steps, self.step = inp.views.shape[0], 0
        self.loss, self.grad, self.change, self.grid, self.seen = [], None, None, None, []
        self.inner, self.inner_refresh = trainer.train_step, trainer.update_occupancy
        trainer.train_step, trainer.update_occupancy = self, self.refresh

    def _fit(self, x):
        """A ``(B, ...)`` input as the program takes it: one field's without
        the scene axis."""
        return x if self.n_scenes else x[0]

    def __call__(self, stage, o, d, target_rgb, target_inst, jitter=None):
        lead = (lambda x: x) if self.n_scenes else (lambda x: x[None])
        self.seen.append(tuple(lead(x.detach()) for x in (o, d, target_rgb)))
        fo, fd, ft, fj = (self._fit(x) for x in draws.batch(self.inp, self.step))
        out = self.inner(stage, fo, fd, ft, target_inst, jitter=fj)
        i, self.step = self.step, self.step + 1
        if i < RECORDED_STEPS:
            self.loss.append(out["total"].detach().double().clone())
        st = self.trainer.opt_state
        if i == 0:
            b1 = plain_field.ADAM_B1
            self.grad = leaf_norms({k: v / (1 - b1) for k, v in st["mu"].items()},
                                   self.n_scenes)
        if i == RECORDED_STEPS - 1:
            now = dict(self.trainer.model.named_parameters())
            self.change = leaf_norms({k: now[k].detach() - v for k, v in self.initial.items()},
                                     self.n_scenes)
            self.initial = None
        if self.step == self.steps:
            vars(self.trainer).pop("train_step")
        return out

    def refresh(self, *args, **kwargs):
        kw = {"jitter": self._fit(self.inp.cell_jitter)}
        if self.inp.cells is not None:
            kw["cells"] = self.inp.cells
        out = self.inner_refresh(**kw)
        grid = self.read_grid()
        self.grid = grid.detach().float().reshape(self.n_scenes or 1, -1).cpu()
        vars(self.trainer).pop("update_occupancy")
        return out

    def readings(self) -> dict:
        if self.step != self.steps or self.grid is None:
            raise RuntimeError(f"the first call ran {self.step} of {self.steps} steps"
                               + ("" if self.grid is not None else " and no refresh"))
        return {"loss": [float(v) for v in self.loss], "grad": self.grad,
                "change": self.change, "grid": self.grid,
                "seen": [tuple(x.cpu() for x in b) for b in self.seen]}


class FieldSession:
    """A field cell's program side: set up as the module docstring says;
    ``call()`` runs one window call."""

    work_unit = "rays"
    step_span = "adam"  # the program's span that opens once a step

    def __init__(self, prefix: str, trainer, call, rays_per_step: int, inp: draws.Inputs,
                 n_scenes: int | None, initial: dict, read_grid):
        self.prefix = prefix  # the program's span names: ``<prefix>.<stage>``
        self._call = call
        self.steps_per_call = inp.views.shape[0]
        self.work_per_call = self.steps_per_call * rays_per_step
        feed = Feed(trainer, inp, n_scenes, initial, read_grid)
        # the first call: fed, FLOP-counted (the frozen JAX rule), and it
        # builds and loads every kernel
        self.flops_per_call = count_flops(self._call)
        self._readings = feed.readings()
        self._call()  # one more, warmed: allocator and library handles settled

    def call(self) -> tuple[int, bool]:
        """One window call: (rays trained, whether its last step's metrics
        are finite)."""
        out = self._call()
        return self.work_per_call, all(math.isfinite(v) for v in out.values())

    def readings(self) -> dict:
        return self._readings

    def close(self) -> None:
        """Drop the program's state (the call holds the trainer)."""
        self._call = None


def _halved(method):
    def step(self, stage, o, d, rgb, inst, *args, jitter=None, **kwargs):
        h = o.shape[-2] // 2
        if jitter is not None:
            jitter = jitter[..., :h, :]
        return method(self, stage, o[..., :h, :], d[..., :h, :], rgb[..., :h, :],
                      inst[..., :h], *args, jitter=jitter, **kwargs)

    return step


def _rolled(method):
    def batch(self, *args, **kwargs):
        o, d, rgb, inst = method(self, *args, **kwargs)
        return o, d, rgb.roll(1, dims=-2), inst  # each ray given another's target

    return batch


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` planted in the program while the block runs: a step that
    leaves its state unchanged (no Adam update), half of each batch left
    out (the loss the mean over the rest), or an answer altered where it is
    produced (each ray's target taken from another ray of its batch, in the
    trainers' ray data)."""
    from instance_nerf_tpu_torch.train import multiscene, ngp_trainer

    field, fleet = ngp_trainer.InstanceFieldTrainer, multiscene.MultiSceneFieldTrainer
    if fault == "state_unchanged":
        swaps = [(ngp_trainer, "adam_update", lambda *a, **k: None),
                 (multiscene, "adam_update", lambda *a, **k: None)]
    elif fault == "half_batch":
        swaps = [(c, "train_step", _halved(c.train_step)) for c in (field, fleet)]
    elif fault == "altered_rays":
        swaps = [(field, "_batch", _rolled(field._batch)),
                 (fleet, "_device_batch", _rolled(fleet._device_batch)),
                 (fleet, "_batch", _rolled(fleet._batch))]
    else:
        raise ValueError(f"unknown fault {fault!r}")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    try:
        for obj, name, new in swaps:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
