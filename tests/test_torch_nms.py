"""Parity of the port's NMS (the plain versions of kernels B1 and B2 and
``ops/nms.py``) with the JAX package: keep masks and top-k indices must be
exactly equal.

The JAX side runs as its own tests run it on the CPU: the dense sweep, the
streamed sweep, and the Pallas kernels in interpret mode. The CUDA kernels
themselves are held against ``nms_boxes_plain`` and ``nms_sweep_plain`` on
the card by ``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.kernels.nms_pallas import nms_boxes_pallas, nms_sweep_pallas
from instance_nerf_tpu.ops import nms as JN
from instance_nerf_tpu.ops.boxes import box_iou_3d as j_iou
from instance_nerf_tpu.ops.rotated_iou import cal_iou_3d as j_iou_obb
from instance_nerf_tpu_torch.kernels.nms_cuda import (
    nms_boxes,
    nms_boxes_plain,
    nms_sweep,
    nms_sweep_plain,
)
from instance_nerf_tpu_torch.ops import nms as TN
from tests.test_boxes import random_aabbs
from tests.test_torch_rotated_iou import random_obbs

torch.set_num_threads(2)


def _sorted_case(seed, n, size=40.0, p_valid=0.9):
    rng = np.random.default_rng(seed)
    boxes = random_aabbs(rng, n, size=size)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(size=n) < p_valid
    order = np.argsort(-np.where(valid, scores, -1e30), kind="stable")
    return boxes[order], valid[order]


def _plain(sboxes, svalid, thr):
    return nms_boxes_plain(torch.from_numpy(sboxes), torch.from_numpy(svalid), thr).numpy()


@pytest.mark.parametrize("n,thr", [(300, 0.3), (257, 0.15), (1, 0.3)])
def test_plain_sweep_matches_dense_and_pallas(n, thr):
    """n = 257: K not a multiple of 128 (the Pallas padding); n = 1: one box."""
    sboxes, svalid = _sorted_case(n, n)
    jb, jv = jnp.asarray(sboxes), jnp.asarray(svalid)
    dense = np.asarray(JN._sweep_xla(j_iou(jb, jb), jv, thr))
    pallas = np.asarray(nms_boxes_pallas(jb, jv, thr, interpret=True))
    got = _plain(sboxes, svalid, thr)
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got, pallas)
    assert got.sum() > 0


def test_plain_sweep_matches_streamed_at_5000():
    sboxes, svalid = _sorted_case(11, 5000, size=120.0)
    want = JN._sweep_xla_streamed(jnp.asarray(sboxes), jnp.asarray(svalid), 0.3)
    np.testing.assert_array_equal(_plain(sboxes, svalid, 0.3), np.asarray(want))


def test_all_invalid_keeps_nothing():
    sboxes, _ = _sorted_case(3, 130)
    svalid = np.zeros(130, bool)
    got = _plain(sboxes, svalid, 0.3)
    assert not got.any()
    jb = jnp.asarray(sboxes)
    want = np.asarray(nms_boxes_pallas(jb, jnp.asarray(svalid), 0.3, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_batched_plain_sweep_matches_vmapped_pallas():
    rng = np.random.default_rng(7)
    b, n = 3, 140
    boxes = np.stack([random_aabbs(rng, n, size=40.0) for _ in range(b)])
    valid = rng.uniform(size=(b, n)) < 0.9
    want = jax.vmap(lambda bb, vv: nms_boxes_pallas(bb, vv, 0.3, interpret=True))(
        jnp.asarray(boxes), jnp.asarray(valid))
    got = _plain(boxes, valid, 0.3)
    np.testing.assert_array_equal(got, np.asarray(want))
    for i in range(b):  # a batch row equals the single-problem sweep
        np.testing.assert_array_equal(got[i], _plain(boxes[i], valid[i], 0.3))


def test_wrapper_checks_inputs():
    boxes = torch.zeros((4, 6))
    with pytest.raises(TypeError):
        nms_boxes(boxes.double(), torch.ones(4, dtype=torch.bool), 0.3)
    with pytest.raises(ValueError):
        nms_boxes(torch.zeros((4, 7)), torch.ones(4, dtype=torch.bool), 0.3)
    with pytest.raises(ValueError):
        nms_boxes(boxes, torch.ones(5, dtype=torch.bool), 0.3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 120
    boxes = random_aabbs(rng, n, size=50.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[10:20] = scores[0]  # ties: the stable sort must break them alike
    valid = rng.uniform(size=n) < 0.85
    for thr in (0.1, 0.3, 0.5):
        want = JN.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr,
                           jnp.asarray(valid), use_pallas=False)
        got = TN.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                          torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_nms_mask_per_class_matches_jax():
    rng = np.random.default_rng(2)
    n = 200  # (11 - 1) classes x 20 rois, as the RCNN inference path
    boxes = random_aabbs(rng, n, size=30.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = np.repeat(np.arange(1, 11), 20).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    want = JN.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(classes), 0.15, valid=jnp.asarray(valid))
    got = TN.batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                              torch.from_numpy(classes), 0.15,
                              valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TN.batched_nms_mask(torch.zeros((0, 6)), torch.zeros(0),
                               torch.zeros(0, dtype=torch.int32), 0.15).shape == (0,)


def test_top_k_by_score_ties_match_lax_top_k():
    scores = np.asarray([1, 3, 3, -1e30, -1e30, 2, 3], np.float32)
    for k, valid in ((5, None), (7, np.asarray([1, 1, 0, 1, 1, 1, 1], bool))):
        ji, jm = JN.top_k_by_score(jnp.asarray(scores), k,
                                   None if valid is None else jnp.asarray(valid))
        ti, tm = TN.top_k_by_score(torch.from_numpy(scores), k,
                                   None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    idx, _ = TN.top_k_by_score(torch.from_numpy(scores[:5]), 5)
    assert idx.tolist() == [1, 2, 0, 3, 4]


def test_obb_raises_not_implemented():
    """OBB NMS above the JAX package's dense limit sweeps the valid boxes
    (no longer raises); more boxes to sweep than the kernels take raise
    ValueError before any IoU is computed."""
    k = JN.DENSE_NMS_MAX
    valid = torch.zeros(k + 1, dtype=torch.bool)
    valid[:3] = True
    assert TN.nms_mask(torch.zeros((k + 1, 7)), torch.ones(k + 1), 0.3,
                       valid).tolist() == [True] * 3 + [False] * (k - 2)
    big = TN.MAX_K + 1
    with pytest.raises(ValueError, match="limit"):
        TN.nms_mask(torch.zeros((big, 7)), torch.ones(big), 0.3)
    assert TN.nms_mask(torch.zeros((3, 7)), torch.ones(3), 0.3).tolist() == [True] * 3


def _iou_case(seed, k, p_valid=0.9):
    """A score-ordered (K, K) IoU-like matrix in [0, 1] (about 8% of the
    entries above 0.7) and a valid mask."""
    rng = np.random.default_rng(seed)
    iou = (rng.uniform(0, 1, (k, k)) ** 4).astype(np.float32)
    return iou, rng.uniform(size=k) < p_valid


_j_pairwise_obb = jax.jit(lambda b: j_iou_obb(b[:, None], b[None]))


def _sweep_plain(iou, valid, thr):
    return nms_sweep_plain(torch.from_numpy(iou), torch.from_numpy(valid), thr).numpy()


@pytest.mark.parametrize("k", [1, 200, 257, 1000])
def test_plain_iou_sweep_matches_dense_and_pallas(k):
    """k = 257: K not a multiple of 128 (the Pallas padding); k = 1: one box."""
    iou, valid = _iou_case(k, k, p_valid=1.0 if k == 1 else 0.9)
    ji, jv = jnp.asarray(iou), jnp.asarray(valid)
    got = _sweep_plain(iou, valid, 0.7)
    np.testing.assert_array_equal(got, np.asarray(JN._sweep_xla(ji, jv, 0.7)))
    np.testing.assert_array_equal(got, np.asarray(nms_sweep_pallas(ji, jv, 0.7, interpret=True)))
    assert got.sum() > 0 and (k == 1 or not got[valid].all())


def test_plain_iou_sweep_on_rotated_iou_and_all_invalid():
    rng = np.random.default_rng(5)
    iou = np.array(_j_pairwise_obb(jnp.asarray(random_obbs(rng, 200))))
    valid = rng.uniform(size=200) < 0.9
    want = nms_sweep_pallas(jnp.asarray(iou), jnp.asarray(valid), 0.3, interpret=True)
    got = _sweep_plain(iou, valid, 0.3)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 < got.sum() < valid.sum()
    none = np.zeros(200, bool)
    assert not _sweep_plain(iou, none, 0.3).any()
    want = nms_sweep_pallas(jnp.asarray(iou), jnp.asarray(none), 0.3, interpret=True)
    assert not np.asarray(want).any()


def test_batched_plain_iou_sweep_matches_vmapped_pallas():
    rng = np.random.default_rng(8)
    iou = (rng.uniform(0, 1, (3, 150, 150)) ** 4).astype(np.float32)
    valid = rng.uniform(size=(3, 150)) < 0.9
    want = jax.vmap(lambda m, v: nms_sweep_pallas(m, v, 0.7, interpret=True))(
        jnp.asarray(iou), jnp.asarray(valid))
    got = _sweep_plain(iou, valid, 0.7)
    np.testing.assert_array_equal(got, np.asarray(want))
    for i in range(3):  # a batch row equals the single-problem sweep
        np.testing.assert_array_equal(got[i], _sweep_plain(iou[i], valid[i], 0.7))


def test_iou_sweep_wrapper_checks_inputs():
    iou = torch.zeros((4, 4))
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        nms_sweep(iou.double(), ok, 0.7)
    with pytest.raises(ValueError):
        nms_sweep(torch.zeros((4, 5)), ok, 0.7)
    with pytest.raises(ValueError):
        nms_sweep(iou, torch.ones(5, dtype=torch.bool), 0.7)
    assert nms_sweep(iou, ok, 0.7).tolist() == [True] * 4


def _obb_margin(boxes, thr):
    """Distance of the closest pairwise OBB IoU to the threshold."""
    iou = np.asarray(_j_pairwise_obb(jnp.asarray(boxes)))
    return np.abs(iou[np.triu_indices(len(boxes), 1)] - thr).min()


@pytest.mark.parametrize("seed", [0, 1])
def test_obb_nms_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 150
    boxes = random_obbs(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[10:20] = scores[0]  # ties: the stable sort must break them alike
    valid = rng.uniform(size=n) < 0.85
    for thr in (0.1, 0.3):
        assert _obb_margin(boxes, thr) >= 1e-5
        want = jax.jit(JN.nms_mask, static_argnums=(2, 4))(
            jnp.asarray(boxes), jnp.asarray(scores), thr, jnp.asarray(valid), False)
        got = TN.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                          torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.sum() < valid.sum()


def test_obb_batched_nms_mask_per_level_matches_jax():
    rng = np.random.default_rng(4)
    n = 160  # 4 levels x 40 candidates, as the RPN's per-level NMS
    boxes = random_obbs(rng, n, size=15.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    levels = np.repeat(np.arange(4), 40).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    assert _obb_margin(boxes, 0.3) >= 1e-5  # over all pairs, so within each level
    want = jax.jit(JN.batched_nms_mask, static_argnums=3)(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(levels), 0.3,
        valid=jnp.asarray(valid))
    got = TN.batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                              torch.from_numpy(levels), 0.3, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the offset trick equals NMS run on each level alone
    for lvl in range(4):
        m = levels == lvl
        alone = TN.nms_mask(torch.from_numpy(boxes[m]), torch.from_numpy(scores[m]), 0.3,
                            torch.from_numpy(valid[m]))
        np.testing.assert_array_equal(got.numpy()[m], alone.numpy())


def _obb_above_limit_case(name, all_valid):
    """(boxes, scores, valid, thr) of 600 OBBs, about 20% invalid unless
    ``all_valid``, score ties among them. ``ties``: axis-aligned boxes with
    integer corners in [0, 4), so many pairs' rotated IoU is exactly the
    threshold 1/2."""
    rng = np.random.default_rng(12)
    n = 600
    if name == "ties":
        lo = rng.integers(0, 3, (n, 3))
        whd = rng.integers(1, 3, (n, 3))
        boxes = np.concatenate([lo + whd / 2, whd, np.zeros((n, 1))], 1).astype(np.float32)
        thr = 0.5
    else:
        boxes, thr = random_obbs(rng, n, size=60.0), 0.3
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[100:140] = scores[7]
    valid = rng.uniform(size=n) < (1.0 if all_valid else 0.8)
    return boxes, scores, valid, thr


@pytest.mark.parametrize("all_valid", [False, True])
@pytest.mark.parametrize("name", ["random", "ties"])
def test_obb_nms_mask_above_dense_limit_matches_streamed(monkeypatch, name, all_valid):
    """Above ``DENSE_NMS_MAX`` (cut to 256) the JAX package streams the OBB
    sweep in 512-row tiles (``_sweep_xla_streamed``); the port sweeps the
    dense IoU of the valid boxes alone (all of them with ``all_valid``).
    Keep masks are equal."""
    monkeypatch.setattr(JN, "DENSE_NMS_MAX", 256)
    boxes, scores, valid, thr = _obb_above_limit_case(name, all_valid)
    iou = np.asarray(_j_pairwise_obb(jnp.asarray(boxes)))
    upper = iou[np.triu_indices(len(boxes), 1)]
    if name == "ties":
        assert (upper == np.float32(thr)).sum() > 100
    else:
        assert np.abs(upper - thr).min() >= 1e-5
    streamed = []
    real = JN._sweep_xla_streamed
    monkeypatch.setattr(JN, "_sweep_xla_streamed",
                        lambda *a, **k: streamed.append(1) or real(*a, **k))
    want = jax.jit(lambda b, s, v: JN.nms_mask(b, s, thr, v, use_pallas=False))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    assert streamed  # the JAX side took the streamed sweep
    seen = []

    def sweep(m, svalid, t):  # records the size of the swept matrix
        seen.append((m.shape[0], bool(svalid.all())))
        return nms_sweep_plain(m, svalid, t)

    got = TN.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                      torch.from_numpy(valid), sweep=sweep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert seen == [(int(valid.sum()), True)]
    assert valid.all() == all_valid
    assert 0 < got.sum() < valid.sum()
    assert not (got & ~torch.from_numpy(valid)).any()


# The CUDA kernels' algorithm (csrc/nms_scan.cuh), replayed in numpy. Phase
# 1 writes a (K, W) uint64 mask, W = ceil(K / 64), bit c of word w of row i
# set iff j = 64 w + c has i < j < K and IoU(i, j) > thr, only the words
# w >= i // 64, and a summary with bit w of row i set iff that word is
# nonzero. Phase 2 loads only the words the summary marks and scans the
# tiles in groups of GROUP, in the kernel's order: warp 0 resolves a
# group's tiles (the window's words at once); meanwhile the helpers OR the
# previous group's kept rows past this window; then the block ORs this
# group's kept rows into the next window. Change this replay with the
# kernels' mask layout or scan.

TILE = 64
GROUP = 8
FULL = (1 << 64) - 1
# what the words left of the diagonal hold here: the scan must never read them
GARBAGE = np.uint64(0xDEADBEEFDEADBEEF)


def _mask_words(hit):
    """Phase 1: the (K, W) mask of a (K, K) bool matrix of tests
    ``IoU(i, j) > thr``, garbage left of the diagonal, and the summary of
    the written nonzero words (a Python int of W bits a row)."""
    k = hit.shape[0]
    nw = -(-k // TILE)
    padded = np.zeros((k, nw * TILE), bool)
    padded[:, :k] = np.triu(hit, 1)
    bits = padded.reshape(k, nw, TILE).astype(np.uint64) << np.arange(TILE, dtype=np.uint64)
    words = np.bitwise_or.reduce(bits, axis=-1)
    written = np.arange(nw)[None, :] >= (np.arange(k) // TILE)[:, None]
    summary = [sum(1 << w for w in np.flatnonzero(written[i] & (words[i] != 0)))
               for i in range(k)]
    return np.where(written, words, GARBAGE), summary


def _kernel_iou(boxes):
    """B1's IoU(i, j) as its mask pass computes it: f32, each volume as
    ``(dx * dy) * dz``, the division only where the boxes intersect."""
    b = boxes.astype(np.float32)
    vol = ((b[:, 3] - b[:, 0]) * (b[:, 4] - b[:, 1])) * (b[:, 5] - b[:, 2])
    whd = np.maximum(np.minimum(b[:, None, 3:], b[None, :, 3:])
                     - np.maximum(b[:, None, :3], b[None, :, :3]), np.float32(0))
    inter = (whd[..., 0] * whd[..., 1]) * whd[..., 2]
    union = (vol[:, None] + vol[None, :]) - inter
    iou = np.zeros_like(inter)
    hit = (inter > 0) & (union > 0)
    iou[hit] = inter[hit] / np.maximum(union[hit], np.float32(1e-12))
    return iou


def _scan(mask, summary, valid):
    """Phase 2: the scan of one problem's mask -> (K,) bool keep."""
    k, nw = mask.shape
    m = mask.tolist()  # Python ints

    def word(i, w):  # only the words the summary marks are loaded
        return m[i][w] if (summary[i] >> w) & 1 else 0

    removed = [0] * nw
    for i in range(nw * TILE):
        if i >= k or not valid[i]:
            removed[i // TILE] |= 1 << (i % TILE)
    prev = []
    for w0 in range(0, nw, GROUP):
        kept_rows = []
        for t in range(w0, min(w0 + GROUP, nw)):  # warp 0
            rem, base = removed[t], t * TILE
            # the diagonal words of the live rows (a removed row's reads as 0)
            diag = [0 if (rem >> r) & 1 else word(base + r, t)
                    for r in range(min(TILE, k - base))]
            todo = ~rem & sum(1 << r for r, d in enumerate(diag) if d) & FULL
            while todo:
                r = (todo & -todo).bit_length() - 1
                rem |= diag[r]
                todo &= (todo - 1) & ~diag[r]
            removed[t] = rem
            kept = [base + r for r in range(len(diag)) if not (rem >> r) & 1]
            for u in range(t + 1, min(w0 + GROUP, nw)):
                for i in kept:
                    removed[u] |= word(i, u)
            kept_rows += kept
        for i in prev:  # the helpers: the previous group, past this window
            for w in range(w0 + GROUP, nw):
                removed[w] |= word(i, w)
        for i in kept_rows:  # after the barrier: the next window
            for w in range(w0 + GROUP, min(w0 + 2 * GROUP, nw)):
                removed[w] |= word(i, w)
        prev = kept_rows
    return np.array([not (removed[i // TILE] >> (i % TILE)) & 1 for i in range(k)])


def _replay(hit, valid):
    hit, valid = np.asarray(hit), np.asarray(valid)
    if hit.ndim == 3:
        return np.stack([_scan(*_mask_words(h), v) for h, v in zip(hit, valid)])
    return _scan(*_mask_words(hit), valid)


# 2049: five groups of the scan, so its far OR (past the next window) runs
EDGE_K = [1, 63, 64, 65, 127, 128, 129, 257, 1000, 2049]
F32_THR = np.float32(0.7)
ULP_ABOVE = np.nextafter(F32_THR, np.float32(1))


def _iou_sweep_case(name):
    """(iou, valid, thr) of one B2 case."""
    if name.startswith("k"):
        k = int(name[1:])
        iou, valid = _iou_case(k, k, p_valid=1.0 if k == 1 else 0.9)
        return iou, valid, 0.7
    rng = np.random.default_rng(9)
    k = 300
    valid = rng.uniform(size=k) < 0.9
    if name == "at_and_ulp_above_thr":  # only exact ties and one-ulp misses
        choice = [F32_THR, ULP_ABOVE, np.nextafter(F32_THR, np.float32(0)), np.float32(0)]
        iou = rng.choice(np.asarray(choice, np.float32), (k, k), p=[0.3, 0.05, 0.3, 0.35])
        return iou, valid, float(F32_THR)
    iou = (rng.uniform(0, 0.7, (k, k))).astype(np.float32)
    if name == "all_invalid":
        return iou, np.zeros(k, bool), 0.7
    if name == "all_kept":
        return iou, np.ones(k, bool), 0.7
    if name == "one_suppresses_all":
        iou[0] = 1.0
        return iou, np.ones(k, bool), 0.7
    assert name == "batched_valid_masks"
    iou = (rng.uniform(0, 1, (3, 150, 150)) ** 4).astype(np.float32)
    valid = np.stack([rng.uniform(size=150) < p for p in (1.0, 0.6, 0.2)])
    return iou, valid, 0.7


@pytest.mark.parametrize("name", [f"k{k}" for k in EDGE_K] + [
    "at_and_ulp_above_thr", "all_invalid", "all_kept", "one_suppresses_all",
    "batched_valid_masks"])
def test_bitmask_replay_of_iou_sweep(name):
    """B2's mask pass and scan (replayed) == the plain sweep == the Pallas
    sweep in interpret mode."""
    iou, valid, thr = _iou_sweep_case(name)
    got = _replay(iou > np.float32(thr), valid)
    np.testing.assert_array_equal(got, _sweep_plain(iou, valid, thr))
    pallas = lambda m, v: nms_sweep_pallas(m, v, thr, interpret=True)  # noqa: E731
    if iou.ndim == 3:
        pallas = jax.vmap(pallas)
    np.testing.assert_array_equal(got, np.asarray(pallas(jnp.asarray(iou), jnp.asarray(valid))))
    if name == "at_and_ulp_above_thr":
        assert (iou == F32_THR).any() and (iou == ULP_ABOVE).any()
        assert 0 < got.sum() < valid.sum()
    expect = {"all_invalid": 0, "all_kept": valid.sum(), "one_suppresses_all": 1}
    assert got.sum() == expect.get(name, got.sum())


def _box_sweep_case(name):
    """(boxes, valid, thr) of one B1 case."""
    if name.startswith("k"):
        k = int(name[1:])
        boxes, valid = _sorted_case(k, k, size=20.0 if k < 1000 else 40.0,
                                    p_valid=1.0 if k == 1 else 0.9)
        return boxes, valid, 0.3
    rng = np.random.default_rng(10)
    k = 300
    if name.startswith("iou_"):
        # integer corners in [0, 4): many pairs' IoU is exactly 1/2
        lo = rng.integers(0, 3, (k, 3))
        boxes = np.concatenate([lo, lo + rng.integers(1, 3, (k, 3))], 1).astype(np.float32)
        half = np.float32(0.5)
        thr = half if name == "iou_at_thr" else np.nextafter(half, np.float32(0))
        return boxes, rng.uniform(size=k) < 0.9, float(thr)
    boxes = random_aabbs(rng, k, size=20.0)
    if name == "all_invalid":
        return boxes, np.zeros(k, bool), 0.3
    if name == "all_kept":  # a 10 x 10 x 3 lattice of disjoint unit boxes
        lo = np.stack(np.meshgrid(*(np.arange(n) * 2.0 for n in (10, 10, 3))), -1).reshape(-1, 3)
        return np.concatenate([lo, lo + 1], 1).astype(np.float32), np.ones(k, bool), 0.3
    if name == "one_suppresses_all":  # one box, k times
        return np.repeat(boxes[:1], k, 0), np.ones(k, bool), 0.3
    assert name == "batched_valid_masks"
    boxes = np.stack([random_aabbs(rng, 150, size=20.0) for _ in range(3)])
    valid = np.stack([rng.uniform(size=150) < p for p in (1.0, 0.6, 0.2)])
    return boxes, valid, 0.3


@pytest.mark.parametrize("name", [f"k{k}" for k in EDGE_K] + [
    "iou_at_thr", "iou_one_ulp_above_thr", "all_invalid", "all_kept", "one_suppresses_all",
    "batched_valid_masks"])
def test_bitmask_replay_of_box_sweep(name):
    """B1's mask pass (its IoU arithmetic) and scan (replayed) == the plain
    sweep == the Pallas sweep in interpret mode."""
    boxes, valid, thr = _box_sweep_case(name)
    batched = boxes.ndim == 3
    ious = np.stack([_kernel_iou(b) for b in boxes]) if batched else _kernel_iou(boxes)
    got = _replay(ious > np.float32(thr), valid)
    np.testing.assert_array_equal(got, _plain(boxes, valid, thr))
    pallas = lambda b, v: nms_boxes_pallas(b, v, thr, interpret=True)  # noqa: E731
    if batched:
        pallas = jax.vmap(pallas)
    np.testing.assert_array_equal(got, np.asarray(pallas(jnp.asarray(boxes), jnp.asarray(valid))))
    if name.startswith("iou_"):
        assert (ious == np.float32(0.5)).any()
        assert 0 < got.sum() < valid.sum()
    if name.startswith("k") and len(boxes) >= 64:
        assert 0 < got.sum() < valid.sum()
    expect = {"all_invalid": 0, "all_kept": valid.sum(), "one_suppresses_all": 1}
    assert got.sum() == expect.get(name, got.sum())


def test_bitmask_replay_never_reads_left_of_the_diagonal():
    """The summary marks only written words, so the garbage left of the
    diagonal is never loaded: with it set to zero the keep mask is the
    same."""
    iou, valid, _ = _iou_sweep_case("k1000")
    mask, summary = _mask_words(iou > F32_THR)
    written = mask != GARBAGE
    assert (~written).sum() > 0
    assert all((summary[i] >> w) & 1 == 0 for i, w in zip(*np.nonzero(~written)))
    clean = np.where(written, mask, np.uint64(0))
    np.testing.assert_array_equal(_scan(mask, summary, valid), _scan(clean, summary, valid))
