"""Offline COCO->NYU40 remap of saved panoptic segmentations (PyTorch-side
copy of ``instance_nerf_tpu.masks2d.coco2nyu40_cli``).

Capability parity with ``Mask2Former_sample/coco2nyu40.py``: apply
``convert_seg`` to already-saved seg npy + segments_info json pairs,
writing NYU40-filtered instance maps (0 = background surfaces,
-1 = unlabeled).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from instance_nerf_tpu_torch.masks2d.match_seg import convert_seg


def main(argv=None):
    p = argparse.ArgumentParser("coco2nyu40")
    p.add_argument("--seg_dir", required=True)
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(args.seg_dir)):
        if not f.endswith(".npy"):
            continue
        seg = np.load(os.path.join(args.seg_dir, f)).astype(np.int32)
        with open(os.path.join(args.seg_dir, f.replace(".npy", ".json"))) as fh:
            info = json.load(fh)
        np.save(os.path.join(args.out_dir, f), convert_seg(seg, info))
        n += 1
    print(json.dumps({"converted": n, "out": args.out_dir}))


if __name__ == "__main__":
    main()
