"""The upper readings of a cell's limits: the control and the planted faults
at the cell's own size, one JSON line a seed.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program]

For each seed it computes the plain reference's readings as the
configuration states them, then in the program's place:

* ``control``: the reference one precision below the configuration's
  (``control_precision`` in the configuration file: TF32 for f32, fp8 for
  bf16), given to the reference as ``precision=``;
* each fault of the cell's entry's ``REFERENCE_FAULTS``, given to the
  reference as ``fault=`` (the field entries': ``half_batch``, half of each
  step's batch left out, the loss the mean over the rest);

and prints each one's numbers (``harness/compare.py:numbers``) against the
reference. Where the cell's limits list ``ray_gap``, it reads 0 there: the
reference in the program's place trains on the benchmark's rays and makes
none of its own. With ``--program`` it also runs the harness
(``run.py:run``, a window of one call) with each of the entry's ``FAULTS``
planted in the program (the entry's ``planted(fault)``) and prints what it
compared. A state left unchanged reads 1 on ``change_gap`` by
construction. A cell whose entry names no faults is refused (exit code 2).
The benchmark's own runs never run this.
"""
import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def faults_of(cell):
    """The cell's entry, which names the faults planted in its cells:
    ``REFERENCE_FAULTS``, and ``FAULTS`` with ``planted(fault)``, a context
    manager that plants one in the program; ``ValueError`` where it names
    none."""
    name = cell.workload["entry"]
    entry = importlib.import_module(f"benchmark.entries.{name}")
    missing = [a for a in ("REFERENCE_FAULTS", "FAULTS", "planted") if not hasattr(entry, a)]
    if missing:
        raise ValueError(f"entry {name!r} names no faults to plant (it has no "
                         f"{', '.join(missing)})")
    return entry


def readings_of(cell, seed: int, device) -> dict:
    """The numbers of the control and each fault planted in the reference,
    against the reference at ``seed``."""
    from benchmark.harness import compare

    entry = faults_of(cell)
    ref_mod = importlib.import_module(f"benchmark.reference.{cell.config_name}")
    own = getattr(ref_mod, "gaps", None)
    kw = dict(cfg=cell.config, traffic=cell.traffic, seed=seed, device=device)
    ref = ref_mod.readings(**kw)
    judged = {"ray_gap": 0.0} if "ray_gap" in cell.workload["limits"] else {}
    kinds = {"control": {"precision": cell.config["control_precision"]},
             **{fault: {"fault": fault} for fault in entry.REFERENCE_FAULTS}}
    out = {"seed": seed}
    for kind, extra in kinds.items():
        out[kind] = {**compare.numbers(ref_mod.readings(**kw, **extra), ref, own), **judged}
    return out


def program_faults(cell, seed: int, device) -> dict:
    """What the harness compares, with each of the entry's ``FAULTS``
    planted in turn."""
    from argparse import Namespace

    from benchmark import run

    entry = faults_of(cell)
    out = {"seed": seed}
    for fault in entry.FAULTS:
        with entry.planted(fault):
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
        faults_of(cell)
    except ValueError as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
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
