"""Local DAVIS-17 J&F over saved palette PNGs (the port's copy of
neurips2023_soc_tpu/cli/eval_davis.py; reference eval_davis.py and
davis2017/): reads the ground-truth Annotations and the result PNGs of each
annotator, runs the unsupervised (or semi-supervised) protocol, prints the
global tables and writes the reference's CSVs. numpy only; PIL reads the
PNGs.

    python -m neurips2023_soc_torch.cli.eval_davis --davis_path <DAVIS> \
        --results_path outputs/davis_valid
"""
from __future__ import annotations

import argparse
import csv
import time
from glob import glob
from os import path
from pathlib import Path

import numpy as np

from ..evaluation.davis import evaluate_sequences

G_MEASURES = ["J&F-Mean", "J-Mean", "J-Recall", "J-Decay", "F-Mean", "F-Recall", "F-Decay"]


def _load_index_masks(d: str, frame_names) -> np.ndarray:
    from PIL import Image

    return np.stack([np.array(Image.open(path.join(d, f"{n}.png"))) for n in frame_names])


def _split_objects(index_masks: np.ndarray, ids=None) -> np.ndarray:
    """Index masks -> (n_obj, T, H, W) binary stack. `ids` fixes the object
    order; by default the ids present in the masks. Semi-supervised results
    are split by the GT's id list (reference davis2017 Results.read_masks
    selects `masks == object_id` per GT id): otherwise a prediction that
    never emits some id would shift every later object onto the wrong GT
    row."""
    if ids is None:
        ids = sorted(set(np.unique(index_masks)) - {0})
    if not len(ids):
        return np.zeros((1,) + index_masks.shape, np.uint8)
    return np.stack([(index_masks == i).astype(np.uint8) for i in ids])


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser("DAVIS 2017 local J&F evaluation")
    parser.add_argument("--davis_path", required=True,
                        help="DAVIS root with Annotations_unsupervised/480p")
    parser.add_argument("--results_path", required=True,
                        help="dir with anno_{0..3}/<video>/<frame>.png")
    parser.add_argument("--set", default="val")
    parser.add_argument("--task", default="unsupervised",
                        choices=["semi-supervised", "unsupervised"],
                        help="evaluation protocol (reference eval_davis.py --task; RVOS "
                             "uses unsupervised)")
    args = parser.parse_args(argv)

    gt_ann = "Annotations_unsupervised" if args.task == "unsupervised" else "Annotations"
    gt_dir = path.join(args.davis_path, gt_ann, "480p")
    with open(path.join(args.davis_path, "ImageSets", "2017", f"{args.set}.txt")) as f:
        sequences = f.read().splitlines()

    t0 = time.time()
    global_rows = []
    for anno_id in range(4):
        seqs = {}
        for seq in sequences:
            frames = sorted(path.splitext(path.basename(p))[0]
                            for p in glob(path.join(gt_dir, seq, "*.png")))
            gt_masks = _load_index_masks(path.join(gt_dir, seq), frames)
            gt_ids = sorted(set(np.unique(gt_masks)) - {0})
            res_masks = _load_index_masks(
                path.join(args.results_path, f"anno_{anno_id}", seq), frames)
            # semi-supervised compares object k with GT object k, so results are
            # split by the GT's ids; unsupervised Hungarian-matches the ids present
            res = _split_objects(res_masks,
                                 gt_ids if args.task == "semi-supervised" else None)
            seqs[seq] = (_split_objects(gt_masks, gt_ids), res)
        result = evaluate_sequences(seqs, task=args.task)
        out = result["global"]
        print(f"anno_{anno_id}: " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
        global_rows.append({"annotator": anno_id, **out})

        # the reference's CSVs per annotator (eval_davis.py:24-29, 40-60):
        # global_results-<set>.csv, one row of the 7 measures;
        # per-sequence_results-<set>.csv, rows "<seq>_<obj>", J-Mean, F-Mean
        anno_dir = Path(args.results_path) / f"anno_{anno_id}"
        with open(anno_dir / f"global_results-{args.set}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(G_MEASURES)
            w.writerow([f"{out[k]:.5f}" for k in G_MEASURES])
        with open(anno_dir / f"per-sequence_results-{args.set}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Sequence", "J-Mean", "F-Mean"])
            for name, (jm, fm) in result["per_object"].items():
                w.writerow([name, f"{jm:.5f}", f"{fm:.5f}"])

    mean = {k: float(np.mean([r[k] for r in global_rows]))
            for k in global_rows[0] if k != "annotator"}
    print("mean over annotators: " + " ".join(f"{k}={v:.4f}" for k, v in mean.items()))
    out_csv = Path(args.results_path) / "global_results.csv"
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(global_rows[0].keys()))
        w.writeheader()
        w.writerows(global_rows)
        w.writerow({"annotator": "mean", **mean})
    print(f"total time: {time.time() - t0:.1f}s; wrote {out_csv}")
    return out_csv


if __name__ == "__main__":
    main()
