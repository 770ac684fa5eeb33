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
    """OBB NMS above the dense limit takes the JAX package's streamed sweep,
    which is not in the port yet; at the limit it runs."""
    k = TN.DENSE_NMS_MAX
    with pytest.raises(NotImplementedError, match="streamed"):
        TN.nms_mask(torch.zeros((k + 1, 7)), torch.ones(k + 1), 0.3)
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
