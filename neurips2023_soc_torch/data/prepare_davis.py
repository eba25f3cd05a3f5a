"""Convert a raw Ref-DAVIS-17 download into the Ref-YouTube-VOS directory
layout consumed by `data/davis.py` and the DAVIS eval/infer CLIs (the port's
copy of neurips2023_soc_tpu/data/prepare_davis.py, standard library only;
reference davis2017/convert_davis_to_ytbs.py).

    python -m neurips2023_soc_torch.data.prepare_davis --data_root <raw> --output_root <out>

Input tree (as distributed):
    DAVIS/ImageSets/2017/{train,val}.txt
    DAVIS/JPEGImages/480p/<video>/
    DAVIS/Annotations_unsupervised/480p/<video>/
    DAVIS/davis_semantics.json
    davis_text_annotations/Davis17_annot{1,2}[_full_video].txt

Output tree:
    {train,valid}/{JPEGImages,Annotations}/<video>/
    {train,valid}/meta.json
    meta_expressions/{train,valid}/meta_expressions.json

Expression ids interleave the two annotators' first-frame and full-video
descriptions per object — ["0","1","2","3"] = [annot1-first, annot1-full,
annot2-first, annot2-full] of object 1, and so on (reference
convert_davis_to_ytbs.py:165-177) — which is exactly the 4-expressions-per-
annotator grouping `cli/infer_davis.py` and `cli/eval_davis.py` expect.
Unlike the reference (which `os.system("mv ...")`s the originals), files are
hard-linked when possible and copied otherwise, leaving the download intact.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path
from typing import Dict, List

# the annotation txts misspell three video names
# (reference convert_davis_to_ytbs.py:134-139)
_VIDEO_NAME_FIXES = {
    "clasic-car": "classic-car",
    "dog-scale": "dogs-scale",
    "motor-bike": "motorbike",
}


def read_split_set(data_root: str) -> tuple[List[str], List[str]]:
    """60 train / 30 val video names (reference convert_davis_to_ytbs.py:25-35)."""
    split_dir = Path(data_root) / "DAVIS" / "ImageSets" / "2017"
    out = []
    for name in ("train.txt", "val.txt"):
        with open(split_dir / name) as f:
            out.append([x.strip() for x in f if x.strip()])
    return out[0], out[1]


def read_expressions_txt(path: str, encoding: str = "utf-8") -> Dict[str, List[Dict]]:
    """Parse one annotator file: `video obj_id "expression"` per line, sorted
    by obj_id per video (reference convert_davis_to_ytbs.py:112-147)."""
    videos: Dict[str, List[Dict]] = {}
    with open(path, encoding=encoding) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            video, obj_id = parts[:2]
            video = _VIDEO_NAME_FIXES.get(video, video)
            exp = " ".join(parts[2:])[1:-1]  # strip the surrounding quotes
            videos.setdefault(video, []).append({"exp": exp, "obj_id": obj_id})
    for video in videos:
        videos[video] = sorted(videos[video], key=lambda e: e["obj_id"])
    return videos


def build_meta_expressions(data_root: str, videos: List[str],
                           frames_by_video: Dict[str, List[str]]) -> Dict:
    """Interleave the 4 annotation variants per object into exp ids
    (reference convert_davis_to_ytbs.py:149-222)."""
    txt_dir = Path(data_root) / "davis_text_annotations"
    annos = [
        read_expressions_txt(txt_dir / "Davis17_annot1.txt"),
        read_expressions_txt(txt_dir / "Davis17_annot1_full_video.txt"),
        # annotator 2's files are latin-1 encoded (reference line 152-153)
        read_expressions_txt(txt_dir / "Davis17_annot2.txt", encoding="latin-1"),
        read_expressions_txt(txt_dir / "Davis17_annot2_full_video.txt",
                             encoding="latin-1"),
    ]
    out = {}
    for video in videos:
        expressions, exp_id = {}, 0
        for per_obj in zip(*(a[video] for a in annos)):
            for e in per_obj:
                expressions[str(exp_id)] = e
                exp_id += 1
        out[video] = {"expressions": expressions,
                      "frames": frames_by_video[video]}
    return {"videos": out}


def build_meta_annotations(data_root: str, videos: List[str]) -> Dict:
    """Per-object categories from davis_semantics.json
    (reference convert_davis_to_ytbs.py:224-262)."""
    with open(Path(data_root) / "DAVIS" / "davis_semantics.json") as f:
        semantics = json.load(f)
    out = {}
    for video in videos:
        objects = {
            str(obj_id): {"category": semantics[video][str(obj_id)]}
            for obj_id in range(1, len(semantics[video]) + 1)
        }
        out[video] = {"objects": objects}
    return {"videos": out}


def _link_or_copy_tree(src: Path, dst: Path):
    def link(s, d):
        try:
            os.link(s, d)
        except OSError:
            shutil.copy2(s, d)

    shutil.copytree(src, dst, copy_function=link, dirs_exist_ok=True)


def prepare_ref_davis(data_root: str, output_root: str) -> None:
    data_root, out = str(data_root), Path(output_root)
    train_set, val_set = read_split_set(data_root)
    davis = Path(data_root) / "DAVIS"

    frames_by_video: Dict[str, List[str]] = {}
    for split, videos in (("train", train_set), ("valid", val_set)):
        for video in videos:
            _link_or_copy_tree(davis / "JPEGImages" / "480p" / video,
                               out / split / "JPEGImages" / video)
            _link_or_copy_tree(
                davis / "Annotations_unsupervised" / "480p" / video,
                out / split / "Annotations" / video)
            frames_by_video[video] = sorted(
                p.stem for p in (out / split / "JPEGImages" / video).iterdir()
            )
        with open(out / split / "meta.json", "w") as f:
            json.dump(build_meta_annotations(data_root, videos), f)
        meta_dir = out / "meta_expressions" / split
        meta_dir.mkdir(parents=True, exist_ok=True)
        with open(meta_dir / "meta_expressions.json", "w") as f:
            json.dump(
                build_meta_expressions(data_root, videos, frames_by_video), f)


def main():
    p = argparse.ArgumentParser(
        "Convert raw Ref-DAVIS-17 to the Ref-YouTube-VOS layout")
    p.add_argument("--data_root", required=True,
                   help="directory containing DAVIS/ and davis_text_annotations/")
    p.add_argument("--output_root", required=True)
    args = p.parse_args()
    print("Converting Ref-DAVIS to the Ref-YouTube-VOS layout...")
    prepare_ref_davis(args.data_root, args.output_root)
    print(f"done -> {args.output_root}")


if __name__ == "__main__":
    main()
