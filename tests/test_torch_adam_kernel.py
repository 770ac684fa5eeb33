"""Kernel B7's host side (``kernels/adam_cuda.py``) on the CPU: the leaf
table and chunk walk that ``adam_step`` hands the kernel, a replay of the
kernel's arithmetic over that walk against the plain version, the CPU path
of ``adam_update``, and the wrapper's checks. The kernel itself is held bit
for bit against ``adam_update_plain`` on the card by ``chip_smoke.py``
(``kernel_adam``).

Tolerance of the replay: the kernel multiplies by the f32 reciprocal of
the bias corrections, as PyTorch's CUDA division by a host scalar does,
where the CPU divides; the moments match exactly and the parameters to a
few ulp.
"""
import ctypes

import numpy as np
import pytest
import torch

from instance_nerf_tpu_torch.kernels import adam_cuda
from instance_nerf_tpu_torch.kernels.adam_cuda import (
    CHUNK,
    FROZEN,
    GRADIENT,
    NO_GRADIENT,
    chunk_plan,
    table_template,
)
from instance_nerf_tpu_torch.models.fast_encode import is_instance_param
from instance_nerf_tpu_torch.train import ngp_trainer as TT

torch.set_num_threads(2)

SIZES = [1, 3, 33, 4097, 2 ** 20 + 5]


def _table(raw: bytes) -> adam_cuda._Table:
    return adam_cuda._Table.from_buffer_copy(raw)


def chunk_span(chunk0, sizes, c: int) -> tuple[int, int, int, int]:
    """The kernel's mapping of chunk ``c`` (``csrc/adam.cu``:
    ``field_adam_kernel`` and ``adam_range``): (leaf, start, end, vector
    end) of the entries it updates, those in ``[start, vector end)`` as
    16-byte vectors (for a leaf whose pointers are 16-byte aligned) and the
    rest one by one."""
    leaf = max(i for i, c0 in enumerate(chunk0) if c0 <= c)
    start = (c - chunk0[leaf]) * CHUNK
    end = min(start + CHUNK, sizes[leaf])
    return leaf, start, end, start + ((end - start) & ~3)


def _walk(t: adam_cuda._Table):
    """Every chunk of the table as the kernel maps it: (slot, start, end,
    vector end)."""
    chunk0 = [t.leaves[i].chunk0 for i in range(t.n_leaves)]
    sizes = [t.leaves[i].n for i in range(t.n_leaves)]
    return [chunk_span(chunk0, sizes, c) for c in range(t.n_chunks)]


def _fake_static(sizes, modes):
    """Leaves at made-up, 16-byte aligned addresses."""
    return tuple((0x10000 * (3 * i + 1), 0x10000 * (3 * i + 2), 0x10000 * (3 * i + 3), n, m)
                 for i, (n, m) in enumerate(zip(sizes, modes)))


def test_chunk_plan_offsets():
    chunk0, total = chunk_plan(SIZES)
    assert chunk0 == [0, 1, 2, 3, 4]
    assert total == 4 + (2 ** 20 + 5 + CHUNK - 1) // CHUNK == 4 + 65
    assert chunk_plan([CHUNK, CHUNK + 1, 0, 2]) == ([0, 1, 3, 3], 4)


@pytest.mark.parametrize("modes", [[GRADIENT] * 5, [NO_GRADIENT, GRADIENT, FROZEN, GRADIENT,
                                                      NO_GRADIENT]])
def test_table_covers_every_entry_once(monkeypatch, modes):
    """The table's leaves, modes and chunk prefix, and the kernel's walk
    over it: each leaf's entries covered once, in vectors of 4 up to its
    last ``n % 4`` entries, which the scalar tail takes."""

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    adam_cuda._grid_blocks.cache_clear()
    try:
        static = _fake_static(SIZES, modes)
        raw, grid, slots = table_template(static, adam_cuda._grid_blocks(0))
    finally:
        adam_cuda._grid_blocks.cache_clear()
    t = _table(raw)
    assert ctypes.sizeof(t) == 3624  # csrc/adam.cu's Table: 64 leaves of 56 bytes and 40
    assert (t.n_leaves, t.n_chunks) == (5, 69)
    assert grid == 69  # fewer chunks than 132 SMs x 4 blocks
    assert slots == tuple((i, m) for i, m in enumerate(modes))
    for i, (p, mu, nu, n, m) in enumerate(static):
        leaf = t.leaves[i]
        assert (leaf.p, leaf.g, leaf.mu, leaf.nu, leaf.n, leaf.mode, leaf.g_rows,
                leaf.g_cols) == (p, None, mu, nu, n, m, 0, 0)
    assert [t.leaves[i].chunk0 for i in range(5)] == chunk_plan(SIZES)[0]
    seen = [np.zeros(n, np.int32) for n in SIZES]
    tails = [0] * 5
    for slot, start, end, vend in _walk(t):
        assert start % CHUNK == 0 and start < end <= start + CHUNK
        assert (vend - start) % 4 == 0 and end - vend < 4
        seen[slot][start:end] += 1
        tails[slot] += end - vend
    assert all((s == 1).all() for s in seen)
    assert tails == [n % 4 for n in SIZES]  # 1, 3, 1, 1, 1


def test_table_leaves_out_empty_leaves_and_caps_the_grid():
    static = _fake_static([0, 5 * CHUNK + 2, 0, 7], [GRADIENT] * 4)
    raw, grid, slots = table_template(static, 3)
    t = _table(raw)
    assert (t.n_leaves, t.n_chunks, grid) == (2, 7, 3)
    assert slots == ((1, GRADIENT), (3, GRADIENT))
    assert [t.leaves[i].chunk0 for i in range(2)] == [0, 6]
    assert table_template((), 4)[1] == 1


def _field_leaves(stage: str):
    """The field model's own 15 leaves at the benchmark's field config
    (instant-ngp's grid: 16 x 2^19 x 2 table entries), and their modes in
    ``stage``: the instance head has no gradient in the rgb stage, the rest
    of the field is frozen in the instance stage."""
    model = TT.build_model(TT.NGPConfig())
    names, params = zip(*model.named_parameters())
    modes = [FROZEN if stage == "instance" and not is_instance_param(n)
             else NO_GRADIENT if stage == "rgb" and n.startswith("inst_") else GRADIENT
             for n in names]
    return names, params, modes


@pytest.mark.parametrize("stage", ["rgb", "instance"])
def test_table_of_the_field_model(stage):
    names, params, modes = _field_leaves(stage)
    sizes = [p.numel() for p in params]
    assert len(names) == 15 and sizes[0] == 16 * 2 ** 19 * 2
    assert sorted(sizes[1:]) == sorted([64 * 32, 64, 16 * 64, 16, 64 * 24, 64, 64 * 64, 64,
                                        3 * 64, 3, 64 * 15, 64, 33 * 64, 33])
    raw, grid, slots = table_template(_fake_static(sizes, modes), 132 * 4)
    t = _table(raw)
    # the table's 1024 chunks and one a MLP leaf, each under CHUNK entries
    assert (t.n_leaves, t.n_chunks, grid) == (15, 1024 + 14, 132 * 4)
    assert [m for _, m in slots] == modes
    want = {"rgb": {GRADIENT: 11, NO_GRADIENT: 4}, "instance": {GRADIENT: 4, FROZEN: 11}}[stage]
    assert {m: modes.count(m) for m in set(modes)} == want
    walk = _walk(t)
    assert [w[0] for w in walk] == [0] * 1024 + list(range(1, 15))
    tails = {names[s]: e - v for s, _, e, v in walk if e - v}
    assert tails == {"color_2.bias": 3, "inst_1.bias": 1}


def _replay(raw: bytes, slots, params, grads, mus, nus, count: int, lr: float) -> None:
    """The kernel's arithmetic in numpy f32 over its chunk walk, on the
    arrays of each slot's leaf (numpy rounds each f32 operation once and
    contracts nothing); a gradient transposed in its last two dims read
    from its own memory by the kernel's index map."""
    t = _table(raw)
    h = adam_cuda.hyper(count, lr)
    f = {k: np.float32(getattr(h, k)) for k, _ in adam_cuda._Hyper._fields_}
    for slot, start, end, _ in _walk(t):
        leaf, mode = slots[slot]
        sl = slice(start, end)
        p, mu, nu = (x.view(-1).numpy()[sl] for x in (params[leaf], mus[leaf], nus[leaf]))
        if mode == GRADIENT:
            g = grads[leaf]
            rows, cols = adam_cuda.grad_layout(params[leaf], g, g.device)
            if cols:
                mem = g.transpose(-1, -2).contiguous().view(-1).numpy()
                i = np.arange(start, end)
                m, rem = i // (rows * cols), i % (rows * cols)
                g = mem[m * rows * cols + rem % cols * rows + rem // cols]
            else:
                g = g.view(-1).numpy()[sl]
            mu[:] = mu * f["b1"] + g * f["c1"]
            nu[:] = nu * f["b2"] + (g * g) * f["c2"]
        else:
            mu *= f["b1"]
            nu *= f["b2"]
        if mode != FROZEN:
            p += ((mu * f["ibc1"]) / (np.sqrt(nu * f["ibc2"]) + f["eps"])) * f["neg_lr"]


@pytest.mark.parametrize("n_scenes", [None, 3])
def test_replay_of_the_kernel_matches_the_plain_version(n_scenes):
    """Three steps of a toy field and of a toy fleet of 3 (rgb -> instance
    -> rgb), gradients random with zeros and entries near eps, the instance
    head without gradient in the rgb steps, the fleet's stacked weights'
    gradients transposed views as autograd gives them, each step from the
    plain version's state: the replay's moments equal the plain version's,
    and its parameters differ by a few ulp of the step's update at most
    (the reciprocal's rounding, magnified by nothing: the update is about
    lr)."""
    cfg = TT.NGPConfig(n_levels=2, table_size=2 ** 9, hidden=8, num_instances=5)
    model = TT.build_model(cfg, n_scenes)
    TT.init_ngp_params(model, 0)
    names = [n for n, _ in model.named_parameters()]
    st = TT.adam_init(model)
    rng = np.random.default_rng(3)
    tol = 4 * np.spacing(np.float32(4 * cfg.lr))
    moved = transposed = 0
    for count, stage in enumerate(("rgb", "instance", "rgb"), start=1):
        grads = {}
        for k, v in model.named_parameters():
            stacked = n_scenes is not None and k.endswith(".weight")
            shape = (*v.shape[:-2], v.shape[-1], v.shape[-2]) if stacked else v.shape
            g = rng.normal(size=shape) * 10.0 ** rng.integers(-16, -2, shape)
            g = torch.from_numpy(np.where(rng.uniform(size=shape) < 0.3, 0.0, g)
                                 .astype(np.float32))
            grads[k] = None if stage == "rgb" and k.startswith("inst_") else (
                g.transpose(-1, -2) if stacked else g)
            transposed += grads[k] is not None and not grads[k].is_contiguous()
        mine = {k: v.detach().clone() for k, v in model.named_parameters()}
        mu = {k: v.clone() for k, v in st["mu"].items()}
        nu = {k: v.clone() for k, v in st["nu"].items()}
        TT.adam_update(model, grads, st, stage, cfg.lr)  # CPU leaves: the plain version
        frozen = [stage == "instance" and not is_instance_param(n) for n in names]
        modes = [FROZEN if fz else NO_GRADIENT if grads[n] is None else GRADIENT
                 for n, fz in zip(names, frozen)]
        raw, _, slots = table_template(_fake_static([mine[n].numel() for n in names], modes), 8)
        before = {k: v.clone() for k, v in mine.items()}
        _replay(raw, slots, [mine[n] for n in names], [grads[n] for n in names],
                [mu[n] for n in names], [nu[n] for n in names], count, cfg.lr)
        assert st["count"] == count
        for n, p in model.named_parameters():
            assert torch.equal(mu[n], st["mu"][n]), n
            assert torch.equal(nu[n], st["nu"][n]), n
            # a few ulp of the update, and the one ulp of p its sum may round across
            gap = (mine[n] - p).abs().detach().numpy()
            assert (gap <= tol + np.spacing(p.detach().abs().numpy())).all(), n
            if stage == "instance" and not is_instance_param(n):
                assert torch.equal(mine[n], before[n]) and torch.equal(p, before[n]), n
            moved += int((mine[n] != before[n]).sum())
    assert moved > 0
    # the fleet's weights with a gradient: 5 in an rgb step, 7 in the instance step
    assert transposed == (0 if n_scenes is None else 5 + 7 + 5)


def test_adam_update_on_cpu_takes_the_plain_path(monkeypatch):
    """CPU parameters never reach the kernel's wrapper: ``launches`` stays,
    and the result is ``adam_update_plain``'s bit for bit."""

    def refuse(*a, **k):
        raise AssertionError("adam_step called for CPU parameters")

    monkeypatch.setattr(adam_cuda, "adam_step", refuse)
    cfg = TT.NGPConfig(n_levels=2, table_size=2 ** 8, hidden=8)
    models = [TT.build_model(cfg) for _ in range(2)]
    for m in models:
        TT.init_ngp_params(m, 1)
    sts = [TT.adam_init(m) for m in models]
    grads = {n: torch.randn_like(p) for n, p in models[0].named_parameters()}
    names = list(grads)
    before = adam_cuda.launches
    for stage in ("rgb", "instance"):
        TT.adam_update(models[0], grads, sts[0], stage, cfg.lr)
        sts[1]["count"] += 1
        adam_cuda.adam_update_plain(
            list(models[1].parameters()), [grads[n] for n in names],
            [sts[1]["mu"][n] for n in names], [sts[1]["nu"][n] for n in names],
            [stage == "instance" and not is_instance_param(n) for n in names],
            sts[1]["count"], cfg.lr)
    assert adam_cuda.launches == before
    assert sts[0]["count"] == sts[1]["count"] == 2
    for (n, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(a, b), n


def _leaves(n=6, dtype=torch.float32, device="cpu"):
    p = torch.zeros(n, dtype=dtype, device=device)
    return [p], [torch.ones(n, device=device)], [torch.zeros(n, device=device)], \
        [torch.zeros(n, device=device)]


def test_wrapper_raises_on_a_bf16_leaf():
    p, g, mu, nu = _leaves(dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        adam_cuda.adam_step(p, g, mu, nu, [False], 1, 1e-2)
    p, g, mu, nu = _leaves()
    with pytest.raises(TypeError, match="float32"):
        adam_cuda.adam_step(p, [g[0].bfloat16()], mu, nu, [False], 1, 1e-2)


def test_grad_layout():
    """A gradient as its parameter, or transposed in its last two dims (a
    fleet's stacked weight's, from autograd); nothing else."""
    p = torch.zeros(2, 5, 3)
    dev = p.device
    assert adam_cuda.grad_layout(p, torch.ones(2, 5, 3), dev) == (0, 0)
    assert adam_cuda.grad_layout(p, torch.ones(2, 3, 5).transpose(1, 2), dev) == (5, 3)
    with pytest.raises(ValueError, match="contiguous"):
        adam_cuda.grad_layout(p, torch.ones(5, 2, 3).transpose(0, 1), dev)
    with pytest.raises(ValueError, match="shapes"):
        adam_cuda.grad_layout(p, torch.ones(2, 3, 5), dev)


def test_wrapper_raises_on_a_non_contiguous_gradient():
    p, _, mu, nu = _leaves(n=12)
    p, mu, nu = [p[0].view(3, 4)], [mu[0].view(3, 4)], [nu[0].view(3, 4)]
    g = torch.ones(3, 8)[:, ::2]
    assert g.shape == p[0].shape and not g.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        adam_cuda.adam_step(p, [g], mu, nu, [False], 1, 1e-2)


def test_wrapper_raises_on_a_leaf_on_another_device():
    p, g, mu, nu = _leaves()
    with pytest.raises(ValueError, match="meta"):
        adam_cuda.adam_step(p, [g[0].to("meta")], mu, nu, [False], 1, 1e-2)
    with pytest.raises(ValueError, match="meta"):
        adam_cuda.adam_step(p, g, [mu[0].to("meta")], nu, [False], 1, 1e-2)
    # one device, but not a CUDA one
    before = adam_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        adam_cuda.adam_step(p, g, mu, nu, [False], 1, 1e-2)
    assert adam_cuda.launches == before


def test_wrapper_raises_on_more_leaves_than_a_launch_takes():
    p, g, mu, nu = (x * (adam_cuda.MAX_LEAVES + 1) for x in _leaves())
    with pytest.raises(ValueError, match="leaves"):
        adam_cuda.adam_step(p, g, mu, nu, [False] * len(p), 1, 1e-2)
