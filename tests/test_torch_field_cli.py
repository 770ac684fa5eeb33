"""The instance field's user-facing half in the port: the trainer's sampling
controls (``set_sampling``, ``measure_hits`` against the JAX trainer's on
the same rays and draws; ``steps_per_call`` against single steps), the
field CLI's ``--preset`` provenance against the JAX CLI's ``make_trainer``,
both CLIs through every mode with ``--device cpu`` on a tiny scene, and a
field checkpoint restoring bit-identical."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.cli import run_instance_field as JC
from instance_nerf_tpu.train import ngp_trainer as JT
from instance_nerf_tpu_torch.cli import run_fleet as TFC
from instance_nerf_tpu_torch.cli import run_instance_field as TC
from instance_nerf_tpu_torch.data.nerf_dataset import (
    load_nerf_scene,
    make_synthetic_nerf_scene,
    write_nerf_scene,
)
from instance_nerf_tpu_torch.models.render import OccupancyGrid
from instance_nerf_tpu_torch.train import ngp_trainer as TT

torch.set_num_threads(2)

SMALL = dict(n_levels=2, table_size=2 ** 8, max_res=32, hidden=16, num_instances=4,
             n_rays=64, n_samples=16, k_occupied=4, occ_res=16)
TINY_FLAGS = ["--n_levels", "2", "--log2_table_size", "8", "--max_res", "32",
              "--num_instances", "4", "--n_rays", "64", "--n_samples", "16",
              "--k_occupied", "4", "--occ_res", "16", "--device", "cpu", "--log_every", "0"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    scene, _ = make_synthetic_nerf_scene(np.random.default_rng(0), n_views=3, hw=(16, 16),
                                         n_blobs=2)
    return str(write_nerf_scene(str(root), scene))


def test_written_scene_loads_in_both_packages(scene_dir):
    from instance_nerf_tpu.data.nerf_dataset import load_nerf_scene as jload

    mine = load_nerf_scene(scene_dir, masks_dir=os.path.join(scene_dir, "masks"))
    theirs = jload(scene_dir, masks_dir=os.path.join(scene_dir, "masks"))
    for f in ("images", "poses", "masks"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f), err_msg=f)
    np.testing.assert_allclose(mine.intrinsics, theirs.intrinsics)
    assert mine.hw == theirs.hw == (16, 16)


@pytest.mark.parametrize("coarse,ray_jitter", [(None, False), (8, True)])
def test_measure_hits_matches_jax(scene_dir, coarse, ray_jitter):
    scene = load_nerf_scene(scene_dir)
    cfg = dict(SMALL, occ_coarse_res=coarse, ray_jitter=ray_jitter)
    jt = JT.InstanceFieldTrainer(JT.NGPConfig(**cfg), seed=0)
    occ = np.where(np.random.default_rng(2).uniform(size=(16,) * 3) < 0.1, 1e3, 0.0)
    jt.occ = jt.occ._replace(grid=jnp.asarray(occ, jnp.float32))
    want = jt.measure_hits(scene, n_rays=100, seed=3)
    tt = TT.InstanceFieldTrainer(TT.NGPConfig(**cfg), seed=0, device="cpu")
    tt.occ = OccupancyGrid(torch.tensor(occ, dtype=torch.float32), 0.01)
    draws = jax.random.uniform(jax.random.key(3), (100, 1 if ray_jitter else 16))
    got = tt.measure_hits(scene, n_rays=100, seed=3, jitter=torch.tensor(np.asarray(draws)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.max() <= 16 and (got == 0).any() and len(np.unique(got)) > 3
    assert got.shape == (100,)
    # with the trainer's own draws: a hit count per ray of the same stream
    own = tt.measure_hits(scene, n_rays=100, seed=3)
    assert own.shape == (100,) and (own >= 0).all()


def test_set_sampling_matches_jax():
    jt = JT.InstanceFieldTrainer(JT.NGPConfig(**SMALL), seed=0)
    tt = TT.InstanceFieldTrainer(TT.NGPConfig(**SMALL), seed=0, device="cpu")
    over = dict(k_buckets=((0.5, 2), (0.5, 4)), k_occupied=8, n_samples=24, ray_jitter=True,
                occ_coarse_res=8, fuse_buckets=False)
    jt.set_sampling(**over)
    tt.set_sampling(**over)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    for tr in (jt, tt):
        with pytest.raises(ValueError, match=r"set_sampling: not sampler fields: \{'lr'\}"):
            tr.set_sampling(lr=1.0)


def test_steps_per_call_equals_single_steps(scene_dir):
    """Calls of 4 steps draw their batches first, in the single steps' order:
    the same params, Adam state, occupancy and streams as single steps."""
    scene = load_nerf_scene(scene_dir, masks_dir=os.path.join(scene_dir, "masks"))
    runs = []
    for spc in (4, 1):
        tr = TT.InstanceFieldTrainer(TT.NGPConfig(**SMALL, occ_update_every=8,
                                                  pallas_grad=True), seed=1, device="cpu")
        tr.train(scene, 10, stage="rgb", log_every=0, steps_per_call=spc)
        tr.train(scene, 6, stage="instance", log_every=0, steps_per_call=spc)
        runs.append(tr)
    a, b = runs
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert torch.equal(a.occ.grid, b.occ.grid)
    assert a.opt_state["count"] == b.opt_state["count"] == 16
    assert a.np_rng.bit_generator.state == b.np_rng.bit_generator.state


ARGVS = [
    [],
    ["--preset", "tpu_fast"],
    ["--preset", "tpu_fast", "--n_rays", "4096"],  # typed: wins over the preset
    ["--preset", "tpu_fast", "--n_samples", "128"],  # typed at its default: still wins
    ["--preset", "tpu_fast", "--k_buckets", "auto"],
    ["--encoding", "fast", "--k_buckets", "0.5:8,0.5:16", "--occ_coarse_res", "32"],
    ["--k_occupied", "0", "--log2_table_size", "12", "--lr", "0.001"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_preset_provenance_matches_jax(argv, monkeypatch):
    """The port's config from the same command line equals the JAX CLI's
    ``NGPConfig``, field by field (the port's ``pallas_grad`` flag left
    off, as the JAX CLI trains)."""
    monkeypatch.setattr(JT, "InstanceFieldTrainer", lambda cfg, seed=0: cfg)
    want = JC.make_trainer(JC.parse_with_provenance(argv))
    args = TC.parse_with_provenance(argv)
    got = TC.make_config(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert args.provided_flags == JC.parse_with_provenance(argv).provided_flags


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_field_cli_every_mode_on_cpu(scene_dir, tmp_path, capsys):
    ckpt, masks = str(tmp_path / "ckpt"), os.path.join(scene_dir, "masks")
    out = _run(TC.main, ["--mode", "train", "--scene", scene_dir, "--steps", "8",
                         "--save_path", ckpt, "--pallas_grad"] + TINY_FLAGS, capsys)
    assert np.isfinite(out["rgb"]) and set(out) == {"rgb", "psnr"}
    trained = torch.load(os.path.join(ckpt, "step_0", "state.pt"), weights_only=True)
    out = _run(TC.main, ["--mode", "train_instance", "--scene", scene_dir, "--masks_dir",
                         masks, "--steps", "4", "--checkpoint", ckpt, "--save_path",
                         str(tmp_path / "inst")] + TINY_FLAGS, capsys)
    assert np.isfinite(out["instance"])
    inst = torch.load(os.path.join(tmp_path, "inst", "step_0", "state.pt"), weights_only=True)
    for k, v in trained["params"].items():  # only the instance head moved
        assert torch.equal(v, inst["params"][k]) != k.startswith("inst_"), k
    renders = str(tmp_path / "renders")
    out = _run(TC.main, ["--mode", "render", "--scene", scene_dir, "--checkpoint", ckpt,
                         "--save_path", renders] + TINY_FLAGS, capsys)
    assert out["rendered"] == 3
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(renders, "rgb_000.png")))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert np.load(os.path.join(renders, "instance_000.npy")).shape == (16, 16)
    feats = str(tmp_path / "f" / "scene.npz")
    out = _run(TC.main, ["--mode", "extract_features", "--checkpoint", ckpt, "--resolution",
                         "8", "--out_features", feats] + TINY_FLAGS, capsys)
    with np.load(feats) as z:
        assert z["rgbsigma"].shape == (8, 8, 8, 4) and np.isfinite(z["rgbsigma"]).all()
        assert z["resolution"].tolist() == [8, 8, 8]
    out = _run(TC.main, ["--mode", "benchmark"] + TINY_FLAGS, capsys)
    assert out["rays_per_s"] > 0 and out["clock"] == "host"


def test_field_cli_auto_ladder_and_checkpoint_restore(scene_dir, tmp_path, capsys):
    """``--k_buckets auto`` warms up, measures, chooses and swaps its ladder;
    a checkpoint restores params and occupancy bit-identical."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--mode", "train", "--scene", scene_dir, "--steps", "36", "--encoding", "fast",
            "--k_buckets", "auto", "--occ_coarse_res", "8", "--save_path", ckpt] + TINY_FLAGS
    out = _run(TC.main, argv, capsys)
    ladder = [(float(f), int(k)) for f, k in
              (p.split(":") for p in out["k_buckets_auto"].split(","))]
    assert abs(sum(f for f, _ in ladder) - 1.0) < 1e-6 and all(k <= 16 for _, k in ladder)
    args = TC.parse_with_provenance(argv)
    a, b = TC.make_trainer(args), TC.make_trainer(args)
    TC.load_state(a, ckpt)
    TC.save_state(a, str(tmp_path / "again"), args)
    TC.load_state(b, str(tmp_path / "again"))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert torch.equal(a.occ.grid, b.occ.grid) and not bool((a.occ.grid == 1e3).all())


def test_fleet_cli_every_mode_on_cpu(tmp_path, capsys):
    rng = np.random.default_rng(3)
    for i in range(2):
        scene, _ = make_synthetic_nerf_scene(rng, n_views=2, hw=(16, 16), n_blobs=1)
        write_nerf_scene(str(tmp_path / f"scene_{i}"), scene, masks_dir="masks_matched")
    flags = ["--scenes", str(tmp_path / "scene_*"), "--n_rays", "32", "--n_samples", "8",
             "--k_occupied", "4", "--occ_res", "8", "--occ_coarse_res", "4", "--table_log2",
             "8", "--n_levels", "2", "--n_features", "2", "--num_instances", "4",
             "--device", "cpu", "--log_every", "0"]
    out = _run(TFC.main, ["--mode", "train", "--steps", "6", "--save_every", "3",
                          "--save_path", str(tmp_path / "fleet"), "--pallas_grad"] + flags,
               capsys)
    assert out["scenes"] == 2 and np.isfinite(out["rgb"])
    out = _run(TFC.main, ["--mode", "train_instance", "--steps", "4", "--masks_subdir",
                          "masks_matched", "--checkpoint", str(tmp_path / "fleet"),
                          "--host_data"] + flags, capsys)
    assert out["stage"] == "instance" and np.isfinite(out["instance"])
    out = _run(TFC.main, ["--mode", "benchmark", "--steps", "4", "--steps_per_call", "2"]
               + flags, capsys)
    assert out["B"] == 2 and out["aggregate_rays_per_s"] > 0 and out["clock"] == "host"
