"""Entry ``field_train``: one scene's instance field, trained by the port's
``InstanceFieldTrainer.train(scene, steps_per_call, stage)`` call after
call, as ``run_instance_field --mode train`` trains it: a call of
``occ_update_every`` steps ends with an occupancy refresh.

Inputs, all from ``--seed`` (``traffic/draws.py``): the scene, the first
call's draws and start grid, and the field's initial weights
(``reference/plain_field.py``, drawn on the card). The window's calls draw
from the trainer's own streams, seeded with the seed.
"""
from __future__ import annotations

from benchmark.entries.field_common import FieldSession, ngp_config
# the faults control.py plants in this entry's cells
from benchmark.entries.field_common import FAULTS, REFERENCE_FAULTS, planted  # noqa: F401
from benchmark.reference import plain_field
from benchmark.traffic import draws


def setup(ctx) -> FieldSession:
    from instance_nerf_tpu_torch.data.nerf_dataset import NeRFScene
    from instance_nerf_tpu_torch.train.ngp_trainer import InstanceFieldTrainer

    cfg, traffic = ctx.config, ctx.traffic
    inp = draws.make(cfg, traffic, ctx.seed, ctx.device)
    sc = inp.scenes[0]
    scene = NeRFScene(images=sc.images, poses=sc.poses, intrinsics=sc.intrinsics,
                      hw=sc.hw, masks=sc.masks)
    trainer = InstanceFieldTrainer(ngp_config(cfg), seed=ctx.seed, device=ctx.device)
    initial = plain_field.init_params(cfg, ctx.seed, ctx.device)
    trainer.model.load_state_dict(initial, strict=True)
    trainer.occ.grid.copy_(inp.grid[0])

    def call():
        return trainer.train(scene, traffic["steps_per_call"], stage=traffic["stage"],
                             log_every=0)

    return FieldSession("field", trainer, call, cfg["n_rays"], inp, None, initial,
                        lambda: trainer.occ.grid)
