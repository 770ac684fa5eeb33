"""The benchmark's own tests (``python -m pytest benchmark/tests``). Tests
of the card take the ``card`` fixture, which decides at run time, never
at import, whether there is one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run these on a machine with one (benchmark/README.md)")
    return torch.device("cuda", 0)


# the cells at a size the CPU runs in seconds: every width and count cut,
# the structure (encodings, stages, calls with their refresh) kept
TINY = {
    "field_hash_rgb": ({"n_levels": 4, "table_size": 2 ** 12, "max_res": 64, "hidden": 16,
                        "n_rays": 256, "n_samples": 32, "k_occupied": 8, "occ_res": 16,
                        "occ_update_every": 4},
                       {"n_views": 4, "hw": [32, 32], "steps_per_call": 4}),
    "fleet_hash_rgb": ({"n_scenes": 3, "n_levels": 4, "table_size": 2 ** 10, "max_res": 64,
                        "hidden": 16, "n_rays": 32, "n_samples": 8, "k_occupied": 4,
                        "occ_res": 8, "occ_coarse_res": 4, "occ_update_every": 4},
                       {"n_views": 4, "hw": [16, 16], "steps_per_call": 4}),
}


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the manifest's cell with ``TINY``'s sizes."""
    import torch

    from benchmark.harness import manifest

    torch.set_num_threads(2)

    def make(name):
        cell = manifest.load_cell(name)
        cfg, traffic = TINY[name]
        cell.config.update(cfg)
        cell.traffic.update(traffic)
        return cell

    return make
