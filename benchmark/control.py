"""The upper readings of a cell's limits: the control and the planted faults
at the cell's own size, one JSON line a seed.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program]

For each seed it computes the plain reference's readings as the
configuration states them, then in the program's place:

* ``control``: the reference one precision below the configuration's
  (``control_precision`` in the configuration file: TF32 for f32, fp8 for
  bf16);
* ``half_batch``: the reference with half of each step's batch left out,
  the loss the mean over the rest;

and prints each one's numbers (``harness/compare.py``) against the
reference. Their ``ray_gap`` is 0: the reference in the program's place
trains on the benchmark's rays and makes none of its own. With
``--program`` it also runs the harness (``run.py:run``, a window of one
call) with each fault of ``FAULTS`` planted in the program and prints
what it compared. A state left unchanged reads 1 on ``change_gap`` by
construction. The benchmark's own runs never run this.
"""
import argparse
import contextlib
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("state_unchanged", "half_batch", "altered_rays")


def readings_of(cell, seed: int, device) -> dict:
    """The numbers of the control and each fault planted in the reference,
    against the reference at ``seed``."""
    from benchmark.harness import compare

    ref_mod = importlib.import_module(f"benchmark.reference.{cell.config_name}")
    kw = dict(cfg=cell.config, traffic=cell.traffic, seed=seed, device=device)
    ref = ref_mod.readings(**kw)
    out = {"seed": seed}
    for kind, extra in (("control", {"precision": cell.config["control_precision"]}),
                        ("half_batch", {"fault": "half_batch"})):
        out[kind] = {**compare.gaps(ref_mod.readings(**kw, **extra), ref), "ray_gap": 0.0}
    return out


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


def program_faults(cell, seed: int, device) -> dict:
    """What the harness compares, with each of ``FAULTS`` planted in turn."""
    from argparse import Namespace

    from benchmark import run

    out = {"seed": seed}
    for fault in FAULTS:
        with planted(fault):
            result = run.run(Namespace(workload=cell.name, seed=seed, seconds=0.001, trace=0),
                             cell, device_override=device)
        out[fault] = {k: v["value"] for k, v in result["compared"].items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true",
                   help="also run the harness with each fault planted in the program")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import device, manifest

    cell = manifest.load_cell(args.workload)
    try:
        device.require_cards(cell.chips)
    except device.NoCard as e:
        print(f"control: {e}", file=sys.stderr)
        return 3
    card = torch.device("cuda", 0)
    for seed in args.seeds:
        got = readings_of(cell, seed, card)
        if args.program:
            got["program"] = program_faults(cell, seed, card)
        print(json.dumps({"workload": args.workload, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
