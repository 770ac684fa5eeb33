"""The reader of kernel B7's roofline share and its byte count: the
kernel's own device time over the traced window (no operation before it
counted with it), its launches times the configuration's least time; no
reading without the kernel or without a trace; the count of the MLP
leaves equal to the port's own model's."""
import json
import os
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.counts import adam, peaks
from benchmark.harness import manifest, trace
from benchmark.tests.test_bench_harness import _Ev

CFG = {"n_levels": 16, "table_size": 2 ** 19, "n_features": 2, "hidden": 64,
       "num_instances": 33}


def _run(events, config=CFG, prefix="field"):
    red = trace.reduce_events(events, (f"{prefix}.", "bench."))
    return SimpleNamespace(trace=red, prefix=prefix, config=config)


def test_bound_counts_the_tables_at_28_and_the_mlps_at_24_bytes():
    assert adam.table_entries(CFG) == 16 * 2 ** 19 * 2
    assert adam.mlp_entries(CFG) == 12276
    assert adam.mlp_entries({**CFG, "n_scenes": 32}) == 32 * 12276
    assert adam.bound_s(CFG) == pytest.approx((28 * 16 * 2 ** 20 + 24 * 12276) / peaks.HBM_BYTES)


def test_mlp_count_is_the_models():
    torch = pytest.importorskip("torch")
    del torch
    from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig, build_model

    for name in ("field_hash", "fleet_hash"):
        with open(os.path.join(manifest.BENCH, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        small = {**cfg, "table_size": 2 ** 8, "n_scenes": min(cfg.get("n_scenes", 1), 2)}
        fields = {"n_levels", "table_size", "n_features", "hidden", "num_instances"}
        model = build_model(NGPConfig(**{k: small[k] for k in fields}),
                            small["n_scenes"] if "n_scenes" in cfg else None)
        sizes = {n: p.numel() for n, p in model.named_parameters()}
        table = sizes.pop("hash_table")
        assert table == adam.table_entries(small)
        assert sum(sizes.values()) == adam.mlp_entries(small)


@pytest.mark.parametrize("name, prefix, scenes", [("adam_roofline", "field", 1),
                                                  ("adam_roofline.fleet", "fleet", 32)])
def test_reader_counts_the_kernel_alone(name, prefix, scenes):
    cfg = {**CFG, "n_scenes": scenes} if scenes > 1 else CFG
    evs = [_Ev("bench.window", 0, 100000), _Ev(f"{prefix}.adam", 100, 50),
           _Ev(f"{prefix}.adam", 50000, 50),
           # a memset just before the first launch on its stream: not the kernel's
           _Ev("Memset (Device)", 900, 100, dev=True),
           _Ev("void (anonymous namespace)::field_adam_kernel(Table)", 1000, 4000, dev=True),
           _Ev("vectorized_elementwise_kernel", 6000, 500, dev=True),
           _Ev("void (anonymous namespace)::field_adam_kernel(Table)", 51000, 6000, dev=True)]
    got = run.load_reader(name)(_run(evs, cfg, prefix))
    assert got == pytest.approx(100.0 * 2 * adam.bound_s(cfg) / 10000e-9)


def test_reader_is_silent_without_the_kernel_or_a_trace():
    evs = [_Ev("bench.window", 0, 1000), _Ev("field.adam", 100, 50),
           _Ev("vectorized_elementwise_kernel", 200, 500, dev=True)]
    read = run.load_reader("adam_roofline")
    assert read(_run(evs)) is None
    assert read(SimpleNamespace(trace=None, prefix="field", config=CFG)) is None
