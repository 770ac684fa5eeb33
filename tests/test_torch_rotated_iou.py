"""Parity of the port's rotated 3D IoU (``ops/rotated_iou.py``) with the JAX
package, and of its chunked pairwise matrix with the unchunked one.

Tolerance: 1e-5 absolute on the IoU. Both packages run the same f32
arithmetic; ``sin``, ``cos`` and ``atan2`` differ between XLA and torch by
an ulp, which moves the corners and can reorder nearly coincident polygon
vertices, both far below 1e-5 of an IoU.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.ops import rotated_iou as JR
from instance_nerf_tpu_torch.ops import rotated_iou as TR

torch.set_num_threads(2)

TOL = 1e-5


def random_obbs(rng, n, size=20.0, lo=2.0, hi=12.0):
    """(n, 7) OBBs (x, y, z, w, l, h, theta) that overlap often."""
    c = rng.uniform(0, size, (n, 3))
    whd = rng.uniform(lo, hi, (n, 3))
    theta = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([c, whd, theta], 1).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    want = np.asarray(fn_j(*map(jnp.asarray, arrays)))
    got = fn_t(*map(torch.from_numpy, arrays)).numpy()
    return got, want


def test_cal_iou_3d_broadcast_matches_jax():
    rng = np.random.default_rng(0)
    a, b = random_obbs(rng, 40), random_obbs(rng, 50)
    got, want = _both(JR.cal_iou_3d, TR.cal_iou_3d, a[:, None], b[None])
    assert got.shape == want.shape == (40, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (want > 0.05).sum() > 50  # many overlapping pairs
    assert np.all((got >= 0) & (got <= 1))


def test_cal_iou_2d_matches_jax():
    rng = np.random.default_rng(1)
    a = random_obbs(rng, 30)[:, [0, 1, 3, 4, 6]]
    b = random_obbs(rng, 30)[:, [0, 1, 3, 4, 6]]
    want = JR.cal_iou(jnp.asarray(a)[:, None], jnp.asarray(b)[None])
    got = TR.cal_iou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=TOL)
    for g, w in zip(got[1:], want[1:]):  # corners and union
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)


CASES = {
    # name: (box1, box2, IoU)
    "identical": ([1.0, 2.0, 3.0, 4.0, 2.0, 5.0, 0.7], [1.0, 2.0, 3.0, 4.0, 2.0, 5.0, 0.7], 1.0),
    "identical_far": ([91.3, 77.9, 40.2, 9.0, 4.5, 6.0, -1.2],
                      [91.3, 77.9, 40.2, 9.0, 4.5, 6.0, -1.2], 1.0),
    "disjoint": ([0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.3], [10.0, 10.0, 10.0, 2.0, 2.0, 2.0, 1.0], 0.0),
    "touching_x": ([0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0], [2.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0], 0.0),
    "touching_z": ([0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.4], [0.0, 0.0, 2.0, 2.0, 2.0, 2.0, 0.4], 0.0),
    "zero_size": ([0.0, 0.0, 0.0, 0.0, 2.0, 2.0, 0.0], [0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0], 0.0),
    "shifted_aligned": ([0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0], [1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 0.0],
                        1.0 / 15.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_special_cases(name):
    b1, b2, iou = CASES[name]
    a, b = np.asarray([b1], np.float32), np.asarray([b2], np.float32)
    got, want = _both(JR.cal_iou_3d, TR.cal_iou_3d, a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, [iou], rtol=0, atol=TOL)


def test_box2corners_matches_jax():
    box = random_obbs(np.random.default_rng(2), 25)[:, [0, 1, 3, 4, 6]]
    got, want = _both(JR.box2corners, TR.box2corners, box)
    assert got.shape == (25, 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_chunked_matrix_equals_unchunked_bitwise():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(random_obbs(rng, 61))
    b = torch.from_numpy(random_obbs(rng, 47))
    whole = TR.cal_iou_3d(a[:, None], b[None])
    one_chunk = TR.pairwise_iou_3d(a, b)
    assert torch.equal(one_chunk, whole)
    for chunk in (47, 300, 1000):  # 1, 6 and 21 rows per chunk
        assert torch.equal(TR.pairwise_iou_3d(a, b, chunk_pairs=chunk), whole)
    want = np.asarray(JR.cal_iou_3d(jnp.asarray(a.numpy())[:, None],
                                    jnp.asarray(b.numpy())[None]))
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=TOL)
    assert TR.pairwise_iou_3d(a[:0], b).shape == (0, 47)
