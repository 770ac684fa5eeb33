"""What the CLIs share: the log set-up, the eval report and the summary
printed by rank 0."""
from __future__ import annotations

import json
import logging
import os
import sys


def setup_logging(args) -> None:
    """Log to stdout and, with ``--log_to_file``, to ``<save_path>/train.log``."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if args.log_to_file and args.save_path:
        os.makedirs(args.save_path, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(args.save_path, "train.log")))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s",
                        handlers=handlers)


def report_eval(metrics: dict, save_path: str) -> None:
    """Print the eval metrics and, with a ``save_path``, write them to
    ``<save_path>/eval.json``."""
    print(json.dumps(metrics, indent=2))
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, "eval.json"), "w") as f:
            json.dump(metrics, f, indent=2)


def finish(summary: dict) -> None:
    """Print a run's summary as JSON on rank 0 (every process outside
    ``torchrun``)."""
    from instance_nerf_tpu_torch.parallel.mesh import is_main

    if is_main():
        print(json.dumps(summary))
