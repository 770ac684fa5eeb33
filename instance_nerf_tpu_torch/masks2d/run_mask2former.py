"""Mask2Former panoptic 2D segmentation CLI shim (PyTorch-side copy of
``instance_nerf_tpu.masks2d.run_mask2former``).

Capability parity with ``Mask2Former_sample/run_mask2former.py``: run a
panoptic 2D segmenter per view and save ``<view>.npy`` (int segment-id
map, 0 = unlabeled) + ``<view>.json`` (segments_info with id,
category_id, isthing, category_name) — exactly the inputs match_seg.py
consumes.

Like the reference, the 2D model is an *external* dependency (reference:
detectron2 Mask2Former; here: HuggingFace
``Mask2FormerForUniversalSegmentation``). Weights must be available
locally (``--model_path``): nothing is downloaded, so the shim validates
the interface and fails with clear instructions when the checkpoint is
absent. The model runs on the card unless ``--device cpu`` is passed.
"""
from __future__ import annotations

import argparse
import json
import os

from instance_nerf_tpu_torch import resolve_device


def run_panoptic(model_path: str, image_paths, out_dir: str,
                 device: str = "cuda", num_workers: int = 1):
    """Panoptic-segment every image; with ``num_workers > 1`` inference
    runs through the AsyncPredictor pipeline (the reference's multi-GPU
    ``AsyncPredictor``, predictor.py:17-220): each worker thread owns a
    model replica and per-view load/preprocess/infer overlaps with the
    main thread's result writing."""
    import numpy as np
    import torch
    from PIL import Image
    from transformers import (
        AutoImageProcessor,
        Mask2FormerForUniversalSegmentation,
    )

    device = resolve_device(device)
    processor = AutoImageProcessor.from_pretrained(model_path)

    def make_predictor(widx: int):
        model = Mask2FormerForUniversalSegmentation.from_pretrained(
            model_path)
        model.eval().to(device)
        id2label = model.config.id2label
        thing_ids = set(getattr(model.config, "thing_ids", []) or [])

        def predict(path):
            img = Image.open(path).convert("RGB")
            inputs = processor(images=img, return_tensors="pt").to(device)
            with torch.no_grad():
                outputs = model(**inputs)
            result = processor.post_process_panoptic_segmentation(
                outputs, target_sizes=[img.size[::-1]]
            )[0]
            seg = result["segmentation"].cpu().numpy().astype(np.int32)
            seg[seg < 0] = 0  # unlabeled
            infos = []
            for info in result["segments_info"]:
                cat = int(info["label_id"])
                infos.append(
                    {
                        "id": int(info["id"]),
                        "category_id": cat,
                        "isthing": cat in thing_ids if thing_ids
                        else bool(info.get("was_fused", False)) is False,
                        "category_name": id2label.get(cat, str(cat)),
                        "score": float(info.get("score", 1.0)),
                    }
                )
            return seg, infos

        return predict

    os.makedirs(out_dir, exist_ok=True)

    def write(path, seg, infos):
        stem = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(out_dir, stem + ".npy"), seg)
        with open(os.path.join(out_dir, stem + ".json"), "w") as f:
            json.dump(infos, f)

    if num_workers > 1:
        from instance_nerf_tpu_torch.masks2d.async_predictor import AsyncPredictor

        with AsyncPredictor(make_predictor, num_workers) as pred:
            for path, (seg, infos) in zip(image_paths,
                                          pred.imap(image_paths)):
                write(path, seg, infos)
    else:
        predict = make_predictor(0)
        for path in image_paths:
            seg, infos = predict(path)
            write(path, seg, infos)
    return len(image_paths)


def main(argv=None):
    p = argparse.ArgumentParser("run_mask2former")
    p.add_argument("--model_path", required=True,
                   help="local HF checkpoint dir, e.g. a download of "
                        "facebook/mask2former-swin-large-coco-panoptic")
    p.add_argument("--input", required=True, help="image dir")
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_workers", type=int, default=1,
                   help="async predictor workers (ref AsyncPredictor)")
    args = p.parse_args(argv)

    if not os.path.isdir(args.model_path):
        raise SystemExit(
            f"Mask2Former checkpoint not found at {args.model_path}. "
            "Download facebook/mask2former-swin-large-coco-panoptic (or any "
            "HF Mask2Former panoptic checkpoint) on a machine with network "
            "access and pass its local path."
        )
    images = sorted(
        os.path.join(args.input, f)
        for f in os.listdir(args.input)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    n = run_panoptic(args.model_path, images, args.output, args.device,
                     num_workers=args.num_workers)
    print(json.dumps({"processed": n, "out": args.output}))


if __name__ == "__main__":
    main()
