"""The port's five-stage pipeline (``instance_nerf_tpu_torch.pipeline``),
the counterpart of ``examples/full_pipeline_synthetic.py``.

``pipeline.main`` runs on the CPU at a tiny size: every summary key of the
JAX example lands, finite, and the files are in the example's layout. The
stage-2 loss (``rcnn_losses``: the box losses and the mask loss of the
first 8 sampled rois) equals the example's ``lf`` composition on converted
weights and the same sampled rois (JAX's sampler, its draws handed over),
each term to 1e-5 relative."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from instance_nerf_tpu.models.backbones import VGG_FPN as JVGG
from instance_nerf_tpu.models import rcnn as JR
from instance_nerf_tpu_torch import pipeline
from instance_nerf_tpu_torch.convert import rcnn_params_from_jax
from instance_nerf_tpu_torch.data.synthetic import jittered_rois
from instance_nerf_tpu_torch.models.backbones import VGG_FPN
from instance_nerf_tpu_torch.models.rcnn import NeRF_RCNN, SampledRois
from tests.test_torch_rpn import _random_params as random_params

torch.set_num_threads(2)

KEYS = ("psnr", "stage1_wall_s", "rcnn_loss", "stage2_wall_s", "detections", "stage3_wall_s",
        "matched_views", "stage4_wall_s", "instance_ce", "pq", "miou", "holdout_render_psnr",
        "stage5_wall_s")


def test_pipeline_main_on_cpu(tmp_path):
    wd = tmp_path / "pipe"
    pipe = pipeline.main(["--workdir", str(wd), "--device", "cpu", "--grid", "24", "--hw", "24",
                          "--views", "4", "--holdout", "1", "--ngp_steps", "8",
                          "--rcnn_steps", "2", "--field_steps", "4"])
    summary = json.load(open(wd / "summary.json"))
    assert summary == json.loads(json.dumps(pipe.summary))
    assert summary["device"] == "cpu" and summary["train_views"] == 3
    for k in KEYS:
        assert np.isfinite(summary[k]), k
    assert 0 <= summary["detections"] <= 4 and 0 <= summary["matched_views"] <= 3
    # the example's files
    assert sorted(os.listdir(wd)) == ["masks.npz", "masks_matched", "projections",
                                      "rgbsigma.npy", "scene", "summary.json"]
    views = [f"r_{v:03d}" for v in range(3)]
    assert sorted(os.listdir(wd / "scene")) == ["boxes.npy", "images", "masks",
                                                "transforms.json"]
    assert sorted(os.listdir(wd / "scene" / "images")) == [v + ".png" for v in views]
    assert sorted(os.listdir(wd / "scene" / "masks")) == [v + ".npy" for v in views]
    assert sorted(os.listdir(wd / "masks_matched")) == [v + ".npy" for v in views]
    assert np.load(wd / "scene" / "boxes.npy").shape == (3, 6)
    grid = np.load(wd / "rgbsigma.npy")
    assert grid.shape == (24, 24, 24, 4) and np.isfinite(grid).all()
    with np.load(wd / "masks.npz") as z:
        assert sorted(z.files) == ["boxes", "labels", "masks", "scores"]
        d = summary["detections"]
        assert z["masks"].shape == (d, 24, 24, 24) and z["boxes"].shape == (d, 6)
    assert {f"{v:04d}.npy" for v in range(3)} <= set(os.listdir(wd / "projections"))
    assert np.load(wd / "masks_matched" / "r_000.npy").shape == (24, 24)


def test_rcnn_loss_matches_the_jax_example():
    g = 24
    rng = np.random.default_rng(0)
    gt = np.asarray([[2.0, 3.0, 2.5, 11.0, 12.0, 10.0], [12.5, 4.0, 6.0, 21.0, 14.5, 18.0],
                     [5.0, 13.0, 11.0, 15.0, 22.0, 21.5]], np.float32)
    rois, _ = jittered_rois(rng, gt, (g, g, g), num_rois=pipeline.N_ROIS, noise=1.0)
    grid = rng.uniform(0, 1, (1, g, g, g, 4)).astype(np.float32)
    inst = np.zeros((g, g, g), np.int64)
    for k, b in enumerate(gt):
        lo, hi = np.floor(b[:3]).astype(int), np.ceil(b[3:]).astype(int)
        inst[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = k + 1
    masks = np.stack([inst == k + 1 for k in range(3)]).astype(np.float32)
    labels = np.arange(1, 4)[None]

    jm = JR.NeRF_RCNN(backbone=JVGG(cfg="AF", input_size=160), num_classes=5,
                      input_shape=(g, g, g))
    shapes = jax.eval_shape(lambda k, x, r: jm.init(k, x, r, with_masks=True),
                            jax.random.key(0), jnp.asarray(grid), jnp.asarray(rois)[None, :4])
    params = random_params(shapes, 5)
    s = JR.select_training_samples(
        jax.random.key(1), jnp.asarray(rois)[None], jnp.ones((1, pipeline.N_ROIS), bool),
        jnp.asarray(gt)[None], jnp.asarray(labels), jnp.ones((1, 3), bool),
        batch_size_per_image=16)

    @jax.jit
    def lf(p, grids, s, masks):  # the example's loss, as it writes it
        f, lg, dl = jm.apply(p, grids, s.rois)
        c, b = JR.fastrcnn_loss(lg, dl, s.labels, s.reg_targets, s.valid)
        mlg = jm.apply(p, f, s.rois[:, :8], method=JR.NeRF_RCNN.mask_forward)
        ml = JR.maskrcnn_loss(mlg[0], s.rois[0, :8], masks, s.labels[0, :8],
                              s.matched_gt_idx[0, :8], s.pos[0, :8])
        return c + b + ml, (c, b, ml)

    want_tot, want = lf(params, jnp.asarray(grid), s, jnp.asarray(masks))
    assert int(np.asarray(s.pos).sum()) > 0

    model = NeRF_RCNN(VGG_FPN(cfg="AF", input_size=160), num_classes=5, input_shape=(g, g, g))
    model.load_state_dict(rcnn_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    ts = SampledRois(*(torch.from_numpy(np.array(x)) for x in s))
    ts = ts._replace(labels=ts.labels.long(), matched_gt_idx=ts.matched_gt_idx.long())
    with torch.no_grad():
        tot, got = pipeline.rcnn_losses(model, torch.from_numpy(grid), ts,
                                        torch.from_numpy(masks))
    for a, b in zip((tot, *got), (want_tot, *want)):
        b = float(b)
        assert abs(float(a) - b) <= 1e-5 * max(abs(b), 1e-6), (float(a), b)
