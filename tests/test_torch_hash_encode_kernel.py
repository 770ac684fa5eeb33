"""Kernel B8's host side (``kernels/hash_encode_cuda.py``) on the CPU: the
routing of ``models/hashgrid.py:hash_encode`` (CPU tensors run the plain
chain and count no launch; anything else goes to B8, which refuses what it
does not take), the launch arguments, and ``corner_rows_plain``, the
kernel's index and weight arithmetic, held to the plain chain: every
corner's flat row and weight bit for bit, the backward's ``grad * w`` bit
for bit against the chain's gradient of its gathered rows, and a replay of
the kernel's forward (its gathers and its order of the 8-term sum) against
the chain's features. The kernel itself is held to the plain chain on the
card by the last test here and by ``chip_smoke.py`` (``kernel_hash_encode``).

No JAX here: the card test runs on a machine without it
(``python -m pytest --noconftest tests/test_torch_hash_encode_kernel.py``).

Tolerance of the forward replay: the chain's CPU sum over the 8 corners
adds in another order than PyTorch's CUDA sum, which the kernel follows;
either order errs by at most 7 u of the sum of the products' magnitudes, so
the two agree within 7 f32 eps of it.
"""
import ctypes

import numpy as np
import pytest
import torch

from instance_nerf_tpu_torch.kernels import hash_encode_cuda as H
from instance_nerf_tpu_torch.kernels import scatter_cuda
from instance_nerf_tpu_torch.models import hashgrid as TH

torch.set_num_threads(2)

# res 4 dense at T = 512 (64 rows) and at T = 1000, res 10 dense at T = 1000
# exactly (res^3 == T) and hashed at 512; 25 and 64 hashed at both
RES = TH.ngp_resolutions(4, 4, 64)
CASES = {  # (B, T): one field and a fleet, T a power of two and not
    "field_pow2": (1, 2 ** 9), "field_odd": (1, 1000),
    "fleet_pow2": (3, 2 ** 9), "fleet_odd": (3, 1000)}
F = 2


def _points(b, n=200, seed=0):
    """``(B, n, 3)`` points in [0, 1] with corners exactly 0 and 1."""
    xyz = np.random.default_rng(seed).uniform(0, 1, (b, n, 3)).astype(np.float32)
    xyz[:, 0] = 1.0  # the +1 corner clamped (its weight 0)
    xyz[:, 1] = 0.0
    xyz[:, 2] = [1.0, 0.5, 0.0]
    xyz[:, 3] = [0.25, 1.0, 1.0]
    return xyz


def _table(b, t, seed=1):
    shape = (len(RES), t, F) if b == 1 else (b, len(RES), t, F)
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _chain(monkeypatch, b, t, pallas_grad=True):
    """The plain chain on the CPU with its flat rows, its corner weights and
    its backward's ``d_rows`` captured: ``(features, grad_feats, flat (N, B,
    L, 8), w (N, B, L, 8), d_rows (N, B, L, 8, F))``."""
    got = {}
    real_gather, real_weights = TH.gather_rows, TH.corner_weights
    real_scatter = scatter_cuda.level_scatter_add

    def gather_rows(table2d, flat, *a, **k):
        got["flat"] = flat
        return real_gather(table2d, flat, *a, **k)

    def corner_weights(frac, *a, **k):
        got["w"] = real_weights(frac, *a, **k)
        return got["w"]

    def level_scatter_add(flat, d_rows, *a, **k):
        got["d_rows"] = d_rows
        return real_scatter(flat, d_rows, *a, **k)

    monkeypatch.setattr(TH, "gather_rows", gather_rows)
    monkeypatch.setattr(TH, "corner_weights", corner_weights)
    monkeypatch.setattr(scatter_cuda, "level_scatter_add", level_scatter_add)
    table = _table(b, t).requires_grad_(True)
    xyz = torch.from_numpy(_points(b) if b > 1 else _points(1)[0])
    feats = TH.hash_encode(table, xyz, RES, pallas_grad=pallas_grad)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=feats.shape).astype(np.float32))
    (feats * g).sum().backward()
    n = xyz.numel() // 3 // b
    shape = (n, b, len(RES), 8)
    flat = got["flat"].numpy().reshape(shape)
    w = got["w"].detach().numpy().reshape(shape)
    d_rows = got["d_rows"].numpy().reshape(*shape, F) if pallas_grad else None
    return feats.detach().numpy(), g.numpy(), flat, w, d_rows


def _grad_per_corner(g, b, n):
    """The features' gradient ``(..., L * F)`` in the caller's layout as
    ``(N, B, L, 1, F)``."""
    return g.reshape(b, n, len(RES), 1, F).transpose(1, 0, 2, 3, 4)


@pytest.mark.parametrize("case", CASES)
def test_corner_rows_plain_is_the_chain(monkeypatch, case):
    b, t = CASES[case]
    _, _, flat, w, _ = _chain(monkeypatch, b, t)
    xyz = _points(b).reshape(-1, 3) if b > 1 else _points(1)[0]
    rows, weights = H.corner_rows_plain(xyz, RES, t, b)
    assert rows.dtype == np.int32 and weights.dtype == np.float32
    np.testing.assert_array_equal(rows, flat)
    assert np.array_equal(weights.view(np.int32), w.view(np.int32))  # bit for bit
    assert (weights[:, :, :, 1:] == 0).any() and (weights == 1).any()  # the corners at 0 and 1
    dense = RES ** 3 <= t
    assert dense.any() and not dense.all()


@pytest.mark.parametrize("case", CASES)
def test_backward_products_are_the_chains(monkeypatch, case):
    """The backward kernel's ``grad * w`` (one f32 product each) equals the
    chain's gradient of its gathered rows bit for bit, in B3's (N, B, L, 8)
    layout."""
    b, t = CASES[case]
    _, g, _, _, d_rows = _chain(monkeypatch, b, t)
    xyz = _points(b).reshape(-1, 3) if b > 1 else _points(1)[0]
    _, weights = H.corner_rows_plain(xyz, RES, t, b)
    n = xyz.shape[0] // b
    want = _grad_per_corner(g, b, n) * weights[..., None]
    assert np.array_equal(want.view(np.int32), d_rows.view(np.int32))


def forward_replay(table, xyz, t, b):
    """B8's forward in numpy: each level's 8 rows gathered with the helper's
    rows, multiplied by its weights, summed as the kernel sums (from 0,
    corner c then c + 4 into accumulator c, then the four in order), in the
    caller's layout."""
    rows, w = H.corner_rows_plain(xyz, RES, t, b)
    v = table.reshape(-1, F)[rows]  # (N, B, L, 8, F)
    prod = v * w[..., None]
    pair = [(np.float32(0) + prod[..., c, :]) + prod[..., c + 4, :] for c in range(4)]
    feats = ((pair[0] + pair[1]) + pair[2]) + pair[3]  # (N, B, L, F)
    return feats.transpose(1, 0, 2, 3).reshape(xyz.shape[0], -1), np.abs(prod).sum(-2)


@pytest.mark.parametrize("case", CASES)
def test_forward_replay_matches_the_chain(monkeypatch, case):
    b, t = CASES[case]
    feats, _, _, _, _ = _chain(monkeypatch, b, t)
    xyz = _points(b).reshape(-1, 3) if b > 1 else _points(1)[0]
    got, mag = forward_replay(_table(b, t).numpy(), xyz, t, b)
    want = feats.reshape(got.shape)
    mag = mag.transpose(1, 0, 2, 3).reshape(got.shape)
    # each order's error is at most 7 u of the magnitudes' sum (u = eps / 2)
    assert np.all(np.abs(got - want) <= 7 * np.finfo(np.float32).eps * mag)


def test_cpu_tensors_run_the_plain_chain_without_a_launch(monkeypatch):
    calls = []
    real = TH.hash_encode_plain
    monkeypatch.setattr(TH, "hash_encode_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    before = (H.launches, H.grad_launches)
    table = _table(3, 2 ** 9).requires_grad_(True)
    out = TH.hash_encode(table, torch.from_numpy(_points(3)), RES, pallas_grad=True)
    out.sum().backward()
    assert calls == [1] and out.shape == (3, 200, len(RES) * F)
    assert (H.launches, H.grad_launches) == before


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_b8_refuses_a_device_other_than_cuda(device):
    """Tensors off the CPU go to B8 (no fallback to the chain), which runs
    on CUDA alone; the wrapper itself refuses CPU tensors too."""
    table = torch.zeros((len(RES), 2 ** 9, F), device=device)
    xyz = torch.zeros((5, 3), device=device)
    if device != "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            TH.hash_encode(table, xyz, RES)
    with pytest.raises(ValueError, match="CUDA"):
        H.hash_encode(table, xyz, RES)


@pytest.mark.parametrize("misuse, error", [
    ("table_f64", TypeError), ("points_bf16", TypeError), ("table_strided", ValueError),
    ("points_not_xyz", ValueError), ("fleet_of_other_b", ValueError),
    ("levels_not_resolutions", ValueError), ("too_many_features", ValueError),
    ("too_many_levels", ValueError), ("rows_past_int32", ValueError),
])
def test_check_refuses_what_b8_does_not_take(misuse, error):
    table, xyz, levels = torch.zeros((len(RES), 64, F)), torch.zeros((7, 3)), len(RES)
    if misuse == "table_f64":
        table = table.double()
    elif misuse == "points_bf16":
        xyz = xyz.bfloat16()
    elif misuse == "table_strided":
        table = torch.zeros((len(RES), 64, 2 * F))[..., :F]
    elif misuse == "points_not_xyz":
        xyz = torch.zeros((7, 2))
    elif misuse == "fleet_of_other_b":
        table = torch.zeros((3, len(RES), 64, F))
        xyz = torch.zeros((2, 7, 3))
    elif misuse == "levels_not_resolutions":
        levels = len(RES) - 1
    elif misuse == "too_many_features":
        table = torch.zeros((len(RES), 64, H.MAX_FEATURES + 1))
    elif misuse == "too_many_levels":
        table, levels = torch.zeros((H.MAX_LEVELS + 1, 4, F)), H.MAX_LEVELS + 1
    else:  # 32 x 16 x 2^22 rows, on the meta device: no memory
        table = torch.empty((32, 16, 2 ** 22, 1), device="meta")
        xyz, levels = torch.empty((32, 7, 3), device="meta"), 16
    with pytest.raises(error):
        H.check(table, xyz, levels)
    H.check(torch.zeros((len(RES), 64, F)), torch.zeros((7, 3)), len(RES))  # sound: no error
    H.check(torch.zeros((3, len(RES), 64, F)), torch.zeros((3, 7, 3)), len(RES))


def test_launch_arguments_mirror_the_kernel():
    """``_Args`` is ``csrc/hash_encode.cu``'s ``EncodeArgs``: 7 pointers, N,
    4 ints and the mask, then 32 resolutions, scales and dense flags; the
    template holds the levels of the benchmark's hash grid."""
    assert ctypes.sizeof(H._Args) == 472
    assert H._Args.res.offset == 84 and H._Args.dense.offset == 340
    res = TH.ngp_resolutions(16, 16, 2048)
    a = H._Args.from_buffer_copy(H._template(tuple(int(r) for r in res), 2 ** 19, 32, 2))
    assert (a.n_scenes, a.n_levels, a.n_features, a.table_size) == (32, 16, 2, 2 ** 19)
    assert a.mask == 2 ** 19 - 1
    assert list(a.res[:16]) == [int(r) for r in res] and list(a.res[16:]) == [0] * 16
    assert list(a.scale[:16]) == [float(np.float32(r) - np.float32(1)) for r in res]
    assert list(a.dense[:16]) == [int(r ** 3 <= 2 ** 19) for r in res]
    assert sum(a.dense[:16]) == 5  # 16 to 58 dense; 81 to 2048 hashed
    assert H._Args.from_buffer_copy(H._template((4, 10), 1000, 1, 2)).mask == 0


def test_b8_on_the_card_equals_the_plain_chain():
    """On a card: B8's features equal the plain chain's run on the card to
    the bit (the kernel follows its sum's order), its backward's rows and
    products equal ``corner_rows_plain``'s bit for bit, and the table
    gradient through B3 and through ``index_add_`` equals the chain's within
    f32 atomics' rounding; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on a machine with one "
                    "(python -m pytest --noconftest tests/test_torch_hash_encode_kernel.py)")
    for case, (b, t) in CASES.items():
        xyz_np = _points(b, n=3000, seed=4) if b > 1 else _points(1, n=3000, seed=4)[0]
        xyz = torch.from_numpy(xyz_np).cuda()
        for pallas_grad in (True, False):
            grads, feats = [], []
            for kernel in (True, False):
                table = _table(b, t).cuda().requires_grad_(True)
                before = (H.launches, H.grad_launches)
                encode = TH.hash_encode if kernel else TH.hash_encode_plain
                out = encode(table, xyz, RES, pallas_grad=pallas_grad)
                g = torch.from_numpy(np.random.default_rng(5).normal(
                    size=out.shape).astype(np.float32)).cuda()
                (out * g).sum().backward()
                torch.cuda.synchronize()
                if kernel:
                    assert (H.launches - before[0], H.grad_launches - before[1]) == (1, 1)
                    rows, d_rows = H.corner_grads(table.shape, xyz, g, RES)
                    want_rows, w = H.corner_rows_plain(xyz_np, RES, t, b)
                    np.testing.assert_array_equal(rows.cpu().numpy().reshape(want_rows.shape),
                                                  want_rows)
                    n = xyz_np.size // 3 // b
                    want = _grad_per_corner(g.cpu().numpy(), b, n) * w[..., None]
                    got = d_rows.cpu().numpy().reshape(want.shape)
                    assert np.array_equal(got.view(np.int32), want.view(np.int32)), case
                feats.append(out.detach().cpu().numpy())
                grads.append(table.grad.cpu().numpy())
            assert np.array_equal(feats[0].view(np.int32), feats[1].view(np.int32)), case
            np.testing.assert_allclose(grads[0], grads[1], rtol=0,
                                       atol=1e-5 * np.abs(grads[1]).max())
        with torch.no_grad():  # no gradient: the features alone, one launch
            before = H.grad_launches
            TH.hash_encode(_table(b, t).cuda().requires_grad_(True), xyz, RES)
            assert H.grad_launches == before
