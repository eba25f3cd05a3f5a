"""COCO run-length encoding (the port's copy of
neurips2023_soc_tpu/evaluation/rle.py): column-major runs starting with a
0-run, written as pycocotools' LEB128-style string, byte for byte what
pycocotools' `encode` gives. The runs are counted by the C++ run counter
`csrc/rle_counts.cpp` (the counterpart of the JAX package's optional
native/rle.cpp), built with the host C++ compiler at its first use;
`counts_numpy` is its plain version."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import numpy as np


@functools.lru_cache(maxsize=None)
def _native_counts():
    """The C entry point rle_counts(data, n, runs) -> number of runs."""
    from ..ops import _build

    fn = _build.load("rle_counts").rle_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    return fn


def _flat(mask: np.ndarray) -> np.ndarray:
    return np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")


def _counts_from_mask(mask: np.ndarray) -> np.ndarray:
    """Column-major (Fortran) run lengths, starting with a 0-run."""
    flat = np.ascontiguousarray(_flat(mask))
    if flat.size == 0:
        return np.zeros(0, np.int64)
    runs = np.empty(flat.size + 1, np.int64)
    return runs[:_native_counts()(flat.ctypes.data, flat.size, runs.ctypes.data)]


def counts_numpy(mask: np.ndarray) -> np.ndarray:
    """The plain version of the run counter, in numpy."""
    flat = _flat(mask)
    if flat.size == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(flat))[0]
    idx = np.concatenate([[-1], change, [flat.size - 1]])
    runs = np.diff(idx).astype(np.int64)
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return runs


def _leb128_encode(counts: np.ndarray) -> bytes:
    """pycocotools' modified LEB128 with delta coding from the 3rd count."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (ch & 0x10)) or (x == -1 and (ch & 0x10)))
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def _leb128_decode(s: bytes) -> np.ndarray:
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            ch = s[i] - 48
            x |= (ch & 0x1F) << (5 * k)
            more = bool(ch & 0x20)
            i += 1
            if not more and (ch & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def _runs_of(rle: Dict) -> np.ndarray:
    """Run lengths of an RLE whose counts are a string, bytes or a list."""
    counts = rle["counts"]
    if isinstance(counts, (list, tuple, np.ndarray)):
        return np.asarray(counts, np.int64)
    if isinstance(counts, str):
        counts = counts.encode()
    return _leb128_decode(counts)


def encode(mask: np.ndarray) -> Dict:
    """(H, W) binary mask -> {'size': [H, W], 'counts': bytes}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _leb128_encode(_counts_from_mask(mask))}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for r in _runs_of(rle):
        if val:
            flat[pos:pos + r] = 1
        pos += int(r)
        val ^= 1
    return flat.reshape((h, w), order="F")


def area(rle: Dict) -> int:
    return int(_runs_of(rle)[1::2].sum())


def iou(dt: List[Dict], gt: List[Dict], iscrowd: List[int] | None = None) -> np.ndarray:
    """Pairwise mask IoU matrix (len(dt), len(gt)); crowd gt uses I/area(dt)."""
    iscrowd = iscrowd or [0] * len(gt)
    out = np.zeros((len(dt), len(gt)), np.float64)
    dms = [decode(d).astype(bool) for d in dt]
    gms = [decode(g).astype(bool) for g in gt]
    for j, (gm, crowd) in enumerate(zip(gms, iscrowd)):
        ga = gm.sum()
        for i, dm in enumerate(dms):
            inter = np.logical_and(dm, gm).sum()
            da = dm.sum()
            union = da if crowd else da + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out
