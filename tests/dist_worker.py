"""One rank of the port's multi-process tests on the CPU: joins a gloo
process group through a ``file://`` store, runs the cases of a spec and
saves each rank's results. It imports only torch, numpy and the port (the
JAX side of a comparison runs in the pytest process).

    python tests/dist_worker.py SPEC.pt RANK

The spec (``torch.save``) holds ``init`` (the store's URL, or None for
one process without a process group), ``world``,
``mesh`` (``make_mesh`` keywords), ``out`` (the results' path prefix,
``<out>.<rank>.pt``) and ``cases``: ``(name, function name, keywords)``.
The functions here also run the one-process side of a comparison
(``mesh=None``), in a process of their own or in the pytest process.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def capture(tx, update: bool = True, dtype=None):
    """Record the gradient list each optimizer step is given (the summed
    one over a process group), in ``dtype`` (default the gradients'); with
    ``update=False`` the step stops there (no moments, no update)."""
    seen = []
    step = tx.step

    def wrapped(grads=None):
        g = grads if grads is not None else [
            p.grad if p.grad is not None else torch.zeros_like(p) for p in tx.params]
        seen.append({n: x.detach().to(dtype or x.dtype, copy=True)
                     for n, x in zip(tx.names, g)})
        return step(grads) if update else None

    tx.step = wrapped
    return seen


def _trainer(kind, cfg, mesh, swin=None, resnet=None):
    """A detector trainer on the CPU; with ``swin`` (``SwinTransformerFPN``
    keywords) or ``resnet`` (``ResNet_FPN_256`` keywords) its backbone is
    that one whatever ``backbone_type`` says."""
    from instance_nerf_tpu_torch.models.backbones import ResNet_FPN_256
    from instance_nerf_tpu_torch.models.swin import SwinTransformerFPN
    from instance_nerf_tpu_torch.train import fcos_trainer, rcnn_trainer, rpn_trainer

    module, cls, conf = {
        "fcos": (fcos_trainer, fcos_trainer.FCOSTrainer, fcos_trainer.FCOSConfig),
        "rpn": (rpn_trainer, rpn_trainer.RPNTrainer, rpn_trainer.RPNConfig),
        "rcnn": (rcnn_trainer, rcnn_trainer.RCNNTrainer, rcnn_trainer.RCNNConfig)}[kind]
    build = module.build_backbone
    if swin is not None:
        module.build_backbone = lambda *a, **k: SwinTransformerFPN(**swin)
    if resnet is not None:
        module.build_backbone = lambda *a, **k: ResNet_FPN_256(**resnet)
    try:
        return cls(conf(**cfg), device="cpu", mesh=mesh)
    finally:
        module.build_backbone = build


def detector_step(mesh, kind, cfg, params, batch, uniforms=None, dtype="float32", swin=None,
                  resnet=None, update=True, grads_dtype=None, n_spatial=None, record=False):
    """One train step of a detector trainer on the global ``batch`` (numpy
    arrays) from ``params`` (a state dict, the path of one, or None for the
    trainer's seeded init): under a process group the trainer builds its
    mesh as it does under ``torchrun`` (from ``cfg["batch_size"]`` and
    ``cfg["n_spatial"]``), or the anchor RPN's is ``make_mesh``'s with
    ``n_spatial`` ranks on W (its config has no spatial axis, as the JAX
    one has none), and steps on this rank's rows (of the scenes, and of W
    on a spatial axis); ``swin`` and ``resnet`` as ``_trainer``'s,
    ``update`` and ``grads_dtype`` (a dtype's name) as ``capture``'s.
    Returns (metrics, the gradients the optimizer was given), and with
    ``record`` (the RPN) a third item: this rank's anchors a level, labels
    and sampled positive and negative masks (``models/rpn.py:sample_anchors``)."""
    from instance_nerf_tpu_torch.models import rpn as rpn_model
    from instance_nerf_tpu_torch.parallel.mesh import batch_shard, make_mesh

    if kind == "rpn" and n_spatial and mesh is not None:
        mesh = make_mesh(n_data=mesh.world // n_spatial, n_spatial=n_spatial, device="cpu")
    else:
        mesh = None  # the trainer's own
    tr = _trainer(kind, cfg, mesh, swin, resnet)
    tr.init_state()
    if params is not None:
        tr.model.load_state_dict(torch.load(params, weights_only=True)
                                 if isinstance(params, str) else params)
    args = [torch.from_numpy(np.asarray(a)) for a in batch]
    if dtype == "float64":
        tr.model.double()
        args = [a.double() if a.is_floating_point() else a for a in args]
    shard = batch_shard(tr.mesh, len(batch[0]))
    kw = {}
    if shard is not None:
        args = [shard.take(a) for a in args]
        kw["shard"] = shard
    if uniforms is not None:
        u = torch.from_numpy(np.asarray(uniforms))
        kw["uniforms"] = u if shard is None else shard.take(u)
    elif kind == "rpn":
        kw["generator"] = tr.gen  # the trainer's seeded draws, on every rank alike
    layout = tr.grid_layout(args[0].shape[1]) if kind in ("fcos", "rpn") else None
    if layout is not None:
        args[0] = layout.take(args[0]).contiguous()
        kw["layout"] = layout
    seen = capture(tr.state.tx, update, grads_dtype and getattr(torch, grads_dtype))
    samples = []
    sample = rpn_model.sample_anchors

    def recorded(*a, **k):
        out = sample(*a, **k)
        samples.append({"level_counts": k["level_counts"], "labels": out[0], "pos": out[2].pos_mask,
                        "neg": out[2].neg_mask})
        return out

    if record:
        rpn_model.sample_anchors = recorded
    try:
        _, metrics = tr.train_step_fn()(tr.state, *args, **kw)
    finally:
        rpn_model.sample_anchors = sample
    grads = seen[0]
    if shard is not None and torch.distributed.get_rank() != 0:
        grads = {k: digest(v) for k, v in grads.items()}  # replicas: rank 0 keeps the tensors
    metrics = {k: float(v) for k, v in metrics.items()}
    return (metrics, grads, samples[0]) if record else (metrics, grads)


def rpn_train_loop(mesh, cfg, n_spatial=None):
    """``RPNTrainer.train_loop`` on this rank in f64 (the model and every
    batch's floats), its mesh ``make_mesh``'s with ``n_spatial`` ranks on W
    (or the trainer's own): (params, Adam's first moments by name)."""
    from instance_nerf_tpu_torch.parallel.mesh import make_mesh
    from instance_nerf_tpu_torch.train import rpn_trainer

    if n_spatial and mesh is not None:
        mesh = make_mesh(n_data=mesh.world // n_spatial, n_spatial=n_spatial, device="cpu")
    else:
        mesh = None
    tr = _trainer("rpn", cfg, mesh)
    tr.model.double()
    load = rpn_trainer.device_batch
    rpn_trainer.device_batch = lambda *a: tuple(
        x.double() if x.is_floating_point() else x for x in load(*a))
    try:
        tr.train_loop()
    finally:
        rpn_trainer.device_batch = load
    return ({k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            dict(zip(tr.state.tx.names, tr.state.tx.mu)))


def spatial_collectives(mesh):
    """``parallel/spatial.py``'s collectives over all ranks on W: rank q's
    block of ``gather_over`` holds ``BLOCKS[q]`` rows (some empty), gathered
    along dim 1 in f64 and int8; ``max_over`` of
    rank-dependent values; a layout whose index is another rank's raises;
    ``RPNTrainer.grid_layout`` of a W that ``sp`` divides and one it does
    not."""
    from instance_nerf_tpu_torch.parallel import spatial as SP
    from instance_nerf_tpu_torch.parallel.mesh import make_mesh

    world = mesh.world
    mesh = make_mesh(n_data=1, n_spatial=world, device="cpu")
    layout = SP.grid_layout(mesh, 40)
    q = layout.index
    x = (torch.arange(2 * BLOCKS[q] * 3, dtype=torch.float64).reshape(2, BLOCKS[q], 3)
         + 100 * q)
    out = {"gathered": SP.gather_over(x, layout, 1, BLOCKS[:world]),
           "gathered_int8": SP.gather_over(x.to(torch.int8), layout, 1, BLOCKS[:world]),
           "max": SP.max_over(torch.tensor([q, -q, 3.0 * (q % 2)]), layout)}
    try:
        SP.max_over(torch.zeros(1), layout._replace(index=(q + 1) % world))
        out["other_rank_raised"] = False
    except RuntimeError:
        out["other_rank_raised"] = True
    tr = _trainer("rpn", dict(backbone_type="vgg_AF", conv_depth=1), mesh)
    out["layout"] = tuple(tr.grid_layout(48 * world))[:3]
    try:
        tr.grid_layout(48 * world + 1)
        out["uneven_raised"] = False
    except ValueError:
        out["uneven_raised"] = True
    return out


# rows of rank q's block in ``spatial_collectives``
BLOCKS = [3, 0, 2, 1]


def digest(t: torch.Tensor) -> str:
    """A tensor's bytes, hashed: equal digests are equal tensors."""
    import hashlib

    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def run_cli(mesh, cli, argv):
    """``instance_nerf_tpu_torch.cli.<cli>.main(argv)`` on this rank."""
    import importlib

    importlib.import_module(f"instance_nerf_tpu_torch.cli.{cli}").main(list(argv))
    return True


def field_step(mesh, cfg, params, occ, rays, stage):
    """``field_loss_and_grads`` on this rank's block of ``rays``
    (unstratified): (metrics, summed gradients)."""
    from instance_nerf_tpu_torch.models.render import OccupancyGrid
    from instance_nerf_tpu_torch.parallel.mesh import local_rows
    from instance_nerf_tpu_torch.train.ngp_trainer import (
        NGPConfig,
        build_model,
        field_loss_and_grads,
    )

    cfg = NGPConfig(**cfg)
    model = build_model(cfg)
    model.load_state_dict(params)
    o, d, rgb, inst = (torch.from_numpy(np.asarray(a)) for a in
                       (local_rows(mesh, rays) if mesh is not None else rays))
    occ = OccupancyGrid(torch.from_numpy(np.asarray(occ)), cfg.occ_threshold)
    group = mesh.data_group if mesh is not None else None
    m, g = field_loss_and_grads(model, cfg, stage, occ, o, d, rgb, inst, group=group,
                                stratified=False)
    return {k: float(v) for k, v in m.items()}, g


def fleet(cfg, n_scenes, hw=(16, 16)):
    """A fleet of ``n_scenes`` synthetic scenes on the CPU; under a process
    group split over the trainer's default mesh."""
    from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
    from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer
    from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig

    rng = np.random.default_rng(0)
    scenes = [make_synthetic_nerf_scene(rng, n_views=3, hw=hw, n_blobs=2)[0]
              for _ in range(n_scenes)]
    return MultiSceneFieldTrainer(scenes, NGPConfig(**cfg), device="cpu")


def fleet_step(mesh, cfg, params, occ, rays, jitter, stage):
    """A fleet's ``loss_and_grads`` on this rank's scenes and rays (the
    whole fleet's ``params`` (B, ...), ``occ``, ``rays`` (B, R, ...) and
    ``jitter``): (per-scene losses of its scenes, its gradients, its scene
    and ray slices)."""
    del mesh  # the trainer's own
    tr = fleet(cfg, occ.shape[0])
    sl, rl = tr._sl, tr._rl
    with torch.no_grad():
        for k, p in tr.model.named_parameters():
            p.copy_(params[k][sl])
    tr.occ_grids = torch.from_numpy(np.asarray(occ)[sl])
    args = [torch.from_numpy(np.asarray(a)[sl, rl]) for a in rays]
    losses, grads = tr.loss_and_grads(stage, *args,
                                      jitter=torch.from_numpy(np.asarray(jitter)[sl, rl]))
    return ({k: v.numpy() for k, v in losses.items()}, grads, (sl.start, sl.stop),
            (rl.start, rl.stop))


def fleet_train_save(mesh, cfg, n_scenes, steps, path):
    """Train a fleet ``steps`` steps, save it under ``path``: (this rank's
    block of params, Adam moments and occupancy, its scene slice)."""
    del mesh  # the trainer's own
    tr = fleet(cfg, n_scenes)
    tr.train(steps, log_every=0)
    tr.save(path, step=steps)
    tr.wait_for_save()
    return ({k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            {m: {k: v.clone() for k, v in tr.opt_state[m].items()} for m in ("mu", "nu")},
            tr.occ_grids.clone(), (tr._sl.start, tr._sl.stop))


def fleet_restore(mesh, cfg, n_scenes, path):
    """A fresh fleet restored from ``path``: as ``fleet_train_save``
    returns."""
    del mesh  # the trainer's own
    tr = fleet(cfg, n_scenes)
    meta = tr.restore(path)
    assert tr.opt_state["count"] == meta["step"]
    return ({k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            {m: {k: v.clone() for k, v in tr.opt_state[m].items()} for m in ("mu", "nu")},
            tr.occ_grids.clone(), (tr._sl.start, tr._sl.stop))


FUNCTIONS = {f.__name__: f for f in (detector_step, run_cli, field_step, fleet_step,
                                     fleet_train_save, fleet_restore, rpn_train_loop,
                                     spatial_collectives)}


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    from instance_nerf_tpu_torch.parallel.mesh import make_mesh

    if spec["init"] is None:  # one process, no process group
        mesh = None
    else:
        mesh = make_mesh(device="cpu", init_method=spec["init"], rank=rank,
                         world_size=spec["world"], **spec.get("mesh", {}))
    for i, (name, fn, kw) in enumerate(spec["cases"]):  # one file a case: memory stays flat
        torch.save(FUNCTIONS[fn](mesh, **kw), f"{spec['out']}.{rank}.{i}.pt")
    if mesh is not None:
        torch.distributed.destroy_process_group()


class Ranks:
    """``world`` processes of this worker running ``cases`` (started by
    ``start``); ``wait`` joins them within ``timeout`` seconds, kills them
    past it, and returns each rank's results (``RankResults``)."""

    def __init__(self, tmp_path, world: int, cases, mesh=None, group: bool = True):
        import subprocess

        self.world, self.names = world, [c[0] for c in cases]
        self.out = str(tmp_path / "result")
        spec = {"init": f"file://{tmp_path / 'store'}" if group else None, "world": world,
                "mesh": mesh or {}, "out": self.out, "cases": cases}
        path = tmp_path / "spec.pt"
        torch.save(spec, path)
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        self.logs = [tmp_path / f"rank{r}.log" for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "wb") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(path), str(r)],
                    env=env, stdout=f, stderr=subprocess.STDOUT))

    def wait(self, timeout: float = 120.0) -> list:
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs) if p.returncode != 0]
        assert not bad, (bad, "\n".join(log.read_text(errors="replace")[-3000:]
                                         for log in self.logs))
        return [RankResults(f"{self.out}.{r}", self.names) for r in range(self.world)]


def start(tmp_path, world: int, cases, mesh=None) -> Ranks:
    return Ranks(tmp_path, world, cases, mesh)


def start_one(tmp_path, cases) -> Ranks:
    """One process of this worker, without a process group (the one-process
    side of a comparison, on one thread as the ranks run)."""
    return Ranks(tmp_path, 1, cases, group=False)


def spawn(tmp_path, world: int, cases, mesh=None, timeout: float = 120.0) -> list:
    """``start`` and ``wait``."""
    return start(tmp_path, world, cases, mesh).wait(timeout)


class RankResults:
    """A rank's results by case name, each loaded from its file when read."""

    def __init__(self, prefix, names):
        self.prefix, self.names = prefix, list(names)

    def __getitem__(self, name):
        return torch.load(f"{self.prefix}.{self.names.index(name)}.pt", weights_only=False)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
