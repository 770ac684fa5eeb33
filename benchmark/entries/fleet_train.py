"""Entry ``fleet_train``: a fleet of B scenes' instance fields, trained by
the port's ``MultiSceneFieldTrainer.train(steps_per_call, stage)`` call
after call: one batched field over the B scenes, the ray draws on the card
from the uint8 / int8 store (``device_data``), an occupancy refresh ending
every call of ``occ_update_every`` steps.

Inputs, all from ``--seed`` (``traffic/draws.py``): B scenes (scene i from
the stream ``(seed, i)``), the first call's draws and start grids, and the
fleet's initial weights (``reference/plain_field.py``, drawn on the card).
The window's calls draw from the trainer's own streams, seeded with the
seed.
"""
from __future__ import annotations

from benchmark.entries.field_common import FieldSession, ngp_config
from benchmark.reference import plain_field
from benchmark.traffic import draws


def setup(ctx) -> FieldSession:
    from instance_nerf_tpu_torch.data.nerf_dataset import NeRFScene
    from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer

    cfg, traffic = ctx.config, ctx.traffic
    b = cfg["n_scenes"]
    inp = draws.make(cfg, traffic, ctx.seed, ctx.device)
    scenes = [NeRFScene(images=s.images, poses=s.poses, intrinsics=s.intrinsics, hw=s.hw,
                        masks=s.masks) for s in inp.scenes]
    trainer = MultiSceneFieldTrainer(scenes, ngp_config(cfg), seed=ctx.seed,
                                     device_data=cfg["device_data"], device=ctx.device)
    initial = plain_field.init_params(cfg, ctx.seed, ctx.device, n_scenes=b)
    trainer.model.load_state_dict(initial, strict=True)
    trainer.occ_grids.copy_(inp.grid)

    def call():
        return trainer.train(traffic["steps_per_call"], stage=traffic["stage"], log_every=0)

    return FieldSession("fleet", trainer, call, b * cfg["n_rays"], inp, b, initial,
                        lambda: trainer.occ_grids)
