"""The port's ``Stages`` spans (``train/timing.py``) on the field and fleet
training paths: one rgb call of a tiny ``InstanceFieldTrainer`` and of a
tiny fleet under ``torch.profiler`` holds the ``draw`` span once a call,
a ``wait`` span at every place the host blocks on the card (nested in the
stage it sits in), and every stage span the paths opened before;
``Stages.upload`` is ``torch.as_tensor``; without a profiler ``Stages``
opens no range; ``profile_ms``' busy share is the union of the device's
intervals. On a card, one call of each path raises no synchronisation
warning outside a ``wait`` span, and neither the encoding (kernel B8) nor
the compositing (kernel B9) opens one.

The counts a call on the CPU: the field uploads the scene's poses once,
each step's view and pixel ids and targets (4, ``rays``) and the encoding's
six host constants (``encode``; in the refresh six per chunk of points,
``occ_update``), waits once a step inside the backward (the plain
compositing's ``cumprod``'s backward reads back whether a factor is 0), and
reads its metrics back (one span for their ``float``s). The fleet's card
draws upload nothing; its host draws upload 4 arrays a batch (``rays``). On
the card the encoding is kernel B8, whose constants are kernel arguments:
no wait in ``encode`` and none in the refresh; and the compositing is
kernel B9, whose backward reads nothing back: no wait in the backward.

No JAX here: the card test runs on a machine without it
(``python -m pytest --noconftest tests/test_torch_stages.py``).
"""
import contextlib
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
from instance_nerf_tpu_torch.train import timing
from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer
from instance_nerf_tpu_torch.train.ngp_trainer import InstanceFieldTrainer, NGPConfig
from instance_nerf_tpu_torch.train.timing import NO_STAGES, Stages, busy_ms

torch.set_num_threads(2)

STEPS = 4  # one call of occ_update_every steps, ending in the refresh
HASH = dict(encoding="hash", n_levels=4, table_size=2 ** 10, n_features=2, base_res=4,
            max_res=64, hidden=16, num_instances=4, occ_update_every=STEPS,
            pallas_grad=True)
FIELD = dict(HASH, n_rays=64, n_samples=16, k_occupied=8, occ_res=16)
FLEET = dict(HASH, n_rays=32, n_samples=8, k_occupied=4, occ_res=8, occ_coarse_res=4,
             occ_subsample=0.25, ray_jitter=True, dtype="bfloat16")
STAGE_SPANS = ("rays", "occupancy", "compact", "encode", "mlp", "composite_loss",
               "backward", "adam")
# the encoding's host constants: resf, corners, res - 1 (hash_encode), r and
# dense (hash_cells), corners (corner_weights)
ENCODE_UPLOADS = 6


def _scenes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [make_synthetic_nerf_scene(rng, n_views=3, hw=(16, 16), n_blobs=2)[0]
            for _ in range(n)]


def _field(device="cpu"):
    tr = InstanceFieldTrainer(NGPConfig(**FIELD), seed=0, device=device)
    scene = _scenes(1)[0]
    return tr, lambda: tr.train(scene, STEPS, log_every=0)


def _fleet(draws, device="cpu"):
    """A fleet of 2 whose call draws on the card (``device``), at once on
    the host (``scan``) or one host batch a step (``single``)."""
    tr = MultiSceneFieldTrainer(_scenes(2), NGPConfig(**FLEET), seed=0,
                                device_data=draws == "device", device=device)
    spc = 1 if draws == "single" else STEPS
    return tr, lambda: tr.train(STEPS, log_every=0, steps_per_call=spc)


def _traced(call, prefix):
    """The call under the profiler: ``(span counts, waits by the stage they
    sit in)``, None for a wait outside every stage."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return _spans(prof, prefix)


def _spans(prof, prefix):
    """A profile's ``(span counts, waits by the stage they sit in)``."""
    own = [e for e in prof.events() if e.name.startswith(prefix + ".")]
    counts = Counter(e.name[len(prefix) + 1:] for e in own)
    inside = Counter()
    for e in own:
        if e.name != f"{prefix}.wait":
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(prefix + "."):
            p = p.cpu_parent
        inside[p.name[len(prefix) + 1:] if p is not None else None] += 1
    return counts, inside


def test_field_call_spans():
    tr, call = _field()
    counts, inside = _traced(call, "field")
    g = FIELD["occ_res"]
    chunks = -(-g ** 3 // 2 ** 18)  # render.update_occupancy's chunks of points
    # the stage spans as before: one a step, composite_loss twice (the
    # composite and the loss), the refresh once a call
    want = {s: STEPS for s in STAGE_SPANS}
    want.update(composite_loss=2 * STEPS, occ_update=1, draw=1)
    assert {k: v for k, v in counts.items() if k != "wait"} == want
    # outside the stages: the poses, and the metrics read back
    assert inside == {"rays": 4 * STEPS, "encode": ENCODE_UPLOADS * STEPS,
                      "backward": STEPS, "occ_update": ENCODE_UPLOADS * chunks, None: 2}
    assert counts["wait"] == sum(inside.values())


@pytest.mark.parametrize("draws", ["device", "scan", "single"])
def test_fleet_call_spans(draws):
    tr, call = _fleet(draws)
    counts, inside = _traced(call, "fleet")
    host_draws = {"device": 0, "scan": 1, "single": STEPS}[draws]
    want = {s: STEPS for s in STAGE_SPANS}
    want.update(composite_loss=2 * STEPS, occ_update=1)
    # one rays span a step on the card; the scan's batches are one rays
    # span a call, and each step's ray math runs outside it
    want["rays"] = {"device": STEPS, "scan": 1, "single": STEPS}[draws]
    if host_draws:
        want["draw"] = host_draws
    assert {k: v for k, v in counts.items() if k != "wait"} == want
    want_waits = {"encode": ENCODE_UPLOADS * STEPS, "backward": STEPS,
                  "occ_update": ENCODE_UPLOADS,  # one chunk of points
                  None: 1}  # the metrics read back (rgb, total)
    if host_draws:
        want_waits["rays"] = 4 * host_draws
    assert inside == want_waits


@pytest.mark.parametrize("x, dtype", [
    (np.linspace(-1.0, 1.0, 7), torch.float32),
    (np.arange(5, dtype=np.int64), None),
    (np.array([True, False, True]), None),
    (np.arange(6, dtype=np.int32).reshape(2, 3), None),
    ([1.5, 2.5], torch.float64),
    (torch.arange(4, dtype=torch.float32), torch.float16),
])
def test_upload_is_as_tensor(x, dtype):
    got = Stages("t").upload(x, "cpu", dtype)
    want = torch.as_tensor(x, dtype=dtype, device="cpu")
    assert got.dtype == want.dtype and got.device == want.device
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))  # bit for bit


def test_upload_opens_a_wait_only_for_a_copy():
    st = Stages("t")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st.upload(np.ones(3), "cpu")
        st.upload(torch.ones(3), "cpu")  # on the device already: no copy
        NO_STAGES.upload(np.ones(3), "cpu")
    names = [e.name for e in prof.events() if e.name.startswith("t.")]
    assert names == ["t.wait"]


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(timing, "record_function",
                        lambda name: opened.append(name) or contextlib.nullcontext())
    st = Stages("t")
    assert not torch.autograd._profiler_enabled()
    with st("encode"):
        st.upload(np.zeros(2), "cpu")
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with st("encode"):
            st.upload(np.zeros(2), "cpu")
        with NO_STAGES("encode"):
            pass
    assert opened == ["t.encode", "t.wait"]


def test_untraced_call_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(timing, "record_function",
                        lambda name: opened.append(name) or contextlib.nullcontext())
    tr, call = _field()
    call()
    assert opened == []


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # two streams overlapping
    ([(0.0, 4.0), (1.0, 2.0), (2.5, 3.0)], 4.0),  # nested
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 1.5), (1.5, 2.0)], 3.0),  # unsorted, touching
    ([(0.0, 1.0), (0.0, 1.0), (0.0, 1.0)], 1.0),  # the same interval thrice
])
def test_busy_ms_is_the_union(intervals, want):
    assert busy_ms(intervals) == pytest.approx(want)
    # the sum of the lengths, as the busy share once counted, reads more
    # wherever the streams overlap
    assert sum(e - s for s, e in intervals) >= busy_ms(intervals)


def test_no_sync_outside_wait_on_the_card(monkeypatch, capsys):
    """Traced, so that every span opens: synchronising is an error but
    inside a ``wait`` span (the card's debug mode is process-wide, so this
    holds on the backward's thread too). Untraced, the call's synchronising
    operations are counted beside its ``wait`` spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on a machine with one "
                    "(python -m pytest --noconftest tests/test_torch_stages.py)")
    real = timing.record_function

    @contextlib.contextmanager
    def allowed_in_wait(name):
        wait = name.endswith(".wait")
        if wait:
            torch.cuda.set_sync_debug_mode(0)
        try:
            with real(name):
                yield
        finally:
            if wait:
                torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(timing, "record_function", allowed_in_wait)
    for label, (tr, call) in (("field", _field("cuda")), ("fleet", _fleet("device", "cuda"))):
        call()  # warm: the kernels built
        torch.cuda.synchronize()
        syncs = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            monkeypatch.setattr(warnings, "showwarning",
                                lambda message, *a, **k: syncs.append(str(message)))
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [m for m in syncs if "called a synchronizing CUDA operation" in m]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()  # raises at a synchronisation outside a wait span
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts, inside = _spans(prof, label)
        waits = counts["wait"]
        with capsys.disabled():
            print(f"\n{label}: one call of {STEPS} steps synchronises {len(syncs)} times "
                  f"and opens {waits} wait spans; none outside them")
        assert syncs and waits
        # the CPU's counts (test_field_call_spans, test_fleet_call_spans)
        # less the encoding's uploads and the backward's read-back: the
        # uploads in rays and the reads outside every stage
        assert inside == ({"rays": 4 * STEPS, None: 2} if label == "field" else {None: 1})
