"""COCO panoptic -> NYU40 class mapping tables (the port's own copy of
``instance_nerf_tpu.masks2d.coco_nyu40``).

Semantics parity with ``Mask2Former_sample/match_seg.py:17-47`` and
``coco2nyu40.py``: NYU40 convention here is 40 = background surface
(wall/floor/ceiling), 0 = unlabeled/void, 39 = otherprop.
"""
from __future__ import annotations

# COCO "things" category names (panoptic) -> NYU40 id
COCO_THINGS_TO_NYU40 = {
    "chair": 5,
    "couch": 6,
    "bed": 4,
    "dining table": 7,
}

# COCO "stuff" category names (panoptic) -> NYU40 id
COCO_STUFF_TO_NYU40 = {
    "chair": 5,
    "couch": 6,
    "bed": 4,
    "dining table": 7,
    "curtain": 40,
    "door-stuff": 40,
    "floor-wood": 40,
    "light": 35,
    "shelf": 10,
    "stairs": 40,
    "wall-brick": 40,
    "wall-stone": 40,
    "wall-tile": 40,
    "wall-wood": 40,
    "window-blind": 40,
    "window-other": 40,
    "ceiling-merged": 40,
    "cabinet-merged": 3,
    "table-merged": 7,
    "floor-other-merged": 40,
    "building-other-merged": 40,
    "wall-other-merged": 40,
}

NYU40_OTHERS = 39
NYU40_BACKGROUND = 40
NYU40_UNLABELED = 0

# NYU40 id -> name (1-based; ref: run_mask2former.py:43-51)
NYU40_CLASS_NAMES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "floormat",
    "clothes", "ceiling", "books", "refrigerator", "television", "paper",
    "towel", "showercurtrain", "box", "whiteboard", "person", "nightstand",
    "toilet", "sink", "lamp", "bathtub", "bag", "otherstructure",
    "otherfurniture", "otherprop",
]


def map_category(name: str, is_thing: bool) -> int:
    table = COCO_THINGS_TO_NYU40 if is_thing else COCO_STUFF_TO_NYU40
    return table.get(name, NYU40_OTHERS)
