"""Whole-video referring inference engine (torch twin of
neurips2023_soc_tpu/inference.py:InferenceEngine).

Per video: frames are copied into engine-owned staging buffers and uploaded;
uint8 frames are normalized on the device; the backbone runs once per chunk,
and the text-dependent head once per chunk for each group of expressions
(`head_groups`), at B = the group's size; trajectory selection (the argmax of
the whole-video score sum, or per chunk) and the finalize step (gather the
chosen query, upsample to the bucket, crop, resize to the original size,
sigmoid, threshold, bit-pack) all run on the device, per expression. Only
the final masks (and, on request, the chosen (T, 4) boxes) come back.

Nothing in a dispatch waits for the device: frames and tokens are copied
into pinned host blocks and uploaded with non_blocking copies, the results
are copied back the same way, and a CUDA event is recorded behind those
copies. Every pinned block comes from PyTorch's caching host allocator, which
hands a block out again only after the copies recorded on it have completed.
Each dispatch ends by handing its video to the engine's worker thread (one
`ThreadPoolExecutor` thread, the evaluators' pattern: `_after_event`), which
waits on that event and unpacks the masks into the public contract, first in,
first out; `_collect_video` only takes the finished result. `infer_videos`
therefore queues video i+1's work before it takes video i's masks, and the
host's unpack of video i runs while the card works through video i+1. The
caller's frames are copied, never aliased, so a caller may reuse its arrays
as soon as a dispatch returns.

Time buckets reach 64 frames, so typical Ref-YouTube-VOS videos run in one
forward and VOC clusters over the whole video; longer videos are chunked.

Frames come as uint8 RGB, float32 normalized, or (y, u, v) YUV420p planes
(converted on the device; `pixel_format="yuv420"` converts uint8 RGB on the
host first, half the upload). Probabilities can travel as float32, bfloat16
or uint8 (`probs_dtype`) and are float32 in [0, 1] for the caller.

Several cards: `EnginePool` holds one engine per CUDA device, each with its
own replica of the model in a worker process of its own, and
`run_videos_pipelined` feeds them from the calling process; `shard_videos`
splits a video list over the processes of a torch.distributed run.
"""
from __future__ import annotations

import copy
import queue
import threading
import traceback
import zipfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data.collate import IMAGENET_MEAN, IMAGENET_STD
from .device import resolve_device
from .models.text_encoder import build_tokenizer
from .ops import resize_bilinear
from .utils.logging import span
from .utils.padded import eval_size_buckets, pick_size_bucket, pick_time_bucket  # noqa: F401

DEFAULT_TIME_BUCKETS = (8, 16, 32, 64)
# frame rows (expressions x bucket frames) of one head call: bounds the head's
# activations, which grow with B x T (the encoder's FFN holds B x T x tokens x
# dim_feedforward)
HEAD_ROWS = 256
PIXEL_FORMATS = ("auto", "yuv420")
PROBS_DTYPES = ("float32", "bfloat16", "uint8")
# DAVIS palette (indices 0..N map through the standard DAVIS colormap)
DAVIS_PALETTE = b"\x00\x00\x00\x80\x00\x00\x00\x80\x00\x80\x80\x00\x00\x00\x80\x80\x00\x80\x00\x80\x80\x80\x80\x80\x40\x00\x00\xc0\x00\x00\x40\x80\x00\xc0\x80\x00\x40\x00\x80\xc0\x00\x80\x40\x80\x80\xc0\x80\x80"


def _normalize_u8_in_graph(pixels: torch.Tensor, pad_mask: torch.Tensor,
                           mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """uint8 (T, B, H, W, 3) -> ImageNet-normalized float32, zeroed on
    padding; the same arithmetic as the dataset's host normalize."""
    x = (pixels.float() / 255.0 - mean) / std
    return x.masked_fill(pad_mask[..., None], 0.0)


def _yuv420_to_normalized(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          pad_mask: torch.Tensor, mean: torch.Tensor,
                          std: torch.Tensor) -> torch.Tensor:
    """YUV420p planes -> ImageNet-normalized RGB float32, zeroed on padding.
    y: (T, B, H, W) uint8; u, v: (T, B, H/2, W/2) uint8, JFIF full-range
    BT.601 (the convention of JPEG and of `rgb_to_yuv420`); chroma is
    upsampled 2x nearest."""
    yf = y.float()
    uf = u.float().repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    vf = v.float().repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    rgb = torch.stack([r, g, b], -1).clamp(0.0, 255.0) / 255.0
    x = (rgb - mean) / std
    return x.masked_fill(pad_mask[..., None], 0.0)


def rgb_to_yuv420(frames: np.ndarray):
    """Host-side RGB -> YUV420p (JFIF full-range BT.601, 2x2 box-averaged
    chroma). frames: (T, h, w, 3) uint8. Returns (y, u, v) uint8 planes with
    u/v at ceil(h/2) x ceil(w/2). For RGB sources this is a lossy 4:2:0
    subsample; frames decoded from a video codec already are YUV420."""
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    yp = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    T, h, w = yp.shape
    ph, pw = (-h) % 2, (-w) % 2
    if ph or pw:  # edge-replicate to even dims before 2x2 averaging
        cb = np.pad(cb, ((0, 0), (0, ph), (0, pw)), mode="edge")
        cr = np.pad(cr, ((0, 0), (0, ph), (0, pw)), mode="edge")
    cb = cb.reshape(T, (h + ph) // 2, 2, (w + pw) // 2, 2).mean((2, 4))
    cr = cr.reshape(T, (h + ph) // 2, 2, (w + pw) // 2, 2).mean((2, 4))

    def to_u8(a):
        return np.clip(np.rint(a), 0, 255).astype(np.uint8)

    return to_u8(yp), to_u8(cb), to_u8(cr)


def _finalize_masks(logits: torch.Tensor, q: torch.Tensor, *, H: int, W: int,
                    fh: int, fw: int, oh: int, ow: int, want_probs: bool,
                    pack: bool, probs_dtype: str = "float32") -> torch.Tensor:
    """Gather query `q`'s stride-4 logits (T, Nq, h4, w4), upsample to the
    (H, W) bucket, crop to the resized content, resize to the original frame
    size, sigmoid, and threshold at 0.5 unless probabilities are wanted. With
    `pack`, masks are bit-packed 8 pixels/byte along width (np.unpackbits
    layout, MSB first). Probabilities travel as `probs_dtype`: float32,
    bfloat16 (2 B/px) or uint8 (1 B/px, prob * 255 rounded)."""
    sel = logits.index_select(1, q.view(1))[:, 0].float()
    up = resize_bilinear(sel[..., None], H, W)[..., 0]
    content = up[:, :fh, :fw]
    if (oh, ow) != (fh, fw):
        content = resize_bilinear(content[..., None], oh, ow)[..., 0]
    prob = torch.sigmoid(content.clamp(-30.0, 30.0))
    if want_probs:
        if probs_dtype == "bfloat16":
            return prob.to(torch.bfloat16)
        if probs_dtype == "uint8":
            return torch.round(prob * 255.0).to(torch.uint8)
        return prob
    mask = (prob > 0.5).to(torch.uint8)
    if not pack:
        return mask
    pad_w = (-ow) % 8
    if pad_w:
        mask = torch.nn.functional.pad(mask, (0, pad_w))
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
    T = mask.shape[0]
    return (mask.view(T, oh, -1, 8).int() << shifts).sum(-1).to(torch.uint8)


def _extract_outputs(out: Dict[str, torch.Tensor]):
    """Last emitted layer, every batch entry: per-query scores (T, B, Nq) (max
    over classes), bf16 stride-4 mask logits (T, B, Nq, h, w), boxes
    (T, B, Nq, 4)."""
    scores = torch.sigmoid(out["pred_cls"][-1].float()).amax(-1)
    return (scores, out["pred_masks"][-1].to(torch.bfloat16), out["pred_boxes"][-1])


def head_groups(n: int, T: int) -> List[range]:
    """The expressions 0..n-1 of a chunk of T bucket frames as the consecutive
    groups that share a head call: at most max(1, HEAD_ROWS // T) each."""
    size = max(1, HEAD_ROWS // T)
    return [range(lo, min(lo + size, n)) for lo in range(0, n, size)]


def _select_in_graph(score_sums: List[torch.Tensor], trajectory: str) -> List[torch.Tensor]:
    """Chosen query per chunk from each chunk's per-query score sum over its
    real frames, as device scalars (no host round trip). 'video': the argmax
    of the whole-video sum (== of the whole-video mean) for every chunk;
    'chunk': each chunk's own argmax."""
    if trajectory == "video":
        q = torch.argmax(torch.stack(score_sums).sum(0))
        return [q] * len(score_sums)
    return [torch.argmax(s) for s in score_sums]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue a device->host copy into pinned memory (no wait)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _after_event(event: Optional[torch.cuda.Event], seen: Optional[threading.Event], fn, *args):
    """The host half of one dispatch, on a worker thread: wait on `event`
    (the card's copies to pinned host memory; None on the CPU), which
    releases the interpreter lock, set `seen` whatever happens, then return
    fn(*args)."""
    try:
        if event is not None:
            event.synchronize()
    finally:
        if seen is not None:
            seen.set()
    return fn(*args)


def _host_worker(device: torch.device, name: str) -> ThreadPoolExecutor:
    """One thread that runs `_after_event` jobs in order, bound to `device`'s
    card on CUDA (it makes no context on another card). It starts on the
    first job and ends once the executor is garbage-collected or shut down."""
    if device.type != "cuda":
        return ThreadPoolExecutor(1, thread_name_prefix=name)
    if device.index is None:  # the card "cuda" means here
        device = torch.device("cuda", torch.cuda.current_device())
    return ThreadPoolExecutor(1, thread_name_prefix=name,
                              initializer=torch.cuda.set_device, initargs=(device,))


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, text_encoder_type: str = "roberta-base",
                 text_bucket: int = 32, time_buckets: Optional[Sequence[int]] = None,
                 size_buckets=((360, 640),), pack_masks: bool = True,
                 pixel_format: str = "auto", probs_dtype: str = "float32",
                 device: Optional[Union[str, torch.device]] = None):
        """Runs `model` (an SOC) on `device`, the CUDA card when None
        (RuntimeError without CUDA). pack_masks bit-packs thresholded masks
        on the device (8 pixels/byte) and unpacks them after the fetch.

        pixel_format: 'auto' takes what the caller passes (float32
        normalized, uint8 RGB, or a (y, u, v) tuple of YUV420p planes);
        'yuv420' also converts uint8 RGB frames to YUV420p on the host
        (rgb_to_yuv420) before the upload, half the bytes, at the cost of
        4:2:0 chroma subsampling.

        probs_dtype: the wire format of return_probs results, 'float32'
        (exact), 'bfloat16' or 'uint8' (prob * 255 rounded); the caller
        always gets float32 in [0, 1]."""
        if pixel_format not in PIXEL_FORMATS:
            raise ValueError(f"unknown pixel_format: {pixel_format!r}")
        if probs_dtype not in PROBS_DTYPES:
            raise ValueError(f"unknown probs_dtype: {probs_dtype!r}")
        self.pixel_format, self.probs_dtype = pixel_format, probs_dtype
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = build_tokenizer(text_encoder_type, text_bucket)
        self.time_buckets = tuple(time_buckets or DEFAULT_TIME_BUCKETS)
        self.size_buckets = tuple(size_buckets)
        self.pack_masks = pack_masks
        self._pad_cache: Dict[tuple, torch.Tensor] = {}
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        # head calls dispatched, and the expressions they held
        self.head_calls = 0
        self.head_expressions = 0
        # videos collected, and those whose result the worker had ready
        self.collects = 0
        self.collects_ready = 0
        self._worker: Optional[ThreadPoolExecutor] = None

    # ---------------- host -> device ----------------
    def _get_pad(self, T: int, H: int, W: int, fh: int, fw: int) -> torch.Tensor:
        """Device-resident pad mask per bucket geometry, made on the device."""
        key = (T, H, W, fh, fw)
        pad = self._pad_cache.get(key)
        if pad is None:
            pad = torch.ones(T, 1, H, W, dtype=torch.bool, device=self.device)
            pad[:, :, :fh, :fw] = False
            self._pad_cache[key] = pad
        return pad

    def _pixel_buffer(self, clip, T: int, H: int, W: int,
                      fh: int, fw: int):
        """Bucket-padded (T, 1, H, W, 3) pixels on the device, or for a
        (y, u, v) clip the three (T, 1, h, w) planes (chroma at half the
        bucket). The clip is copied into engine-owned buffers; padded frames
        repeat the last frame's content."""
        if isinstance(clip, tuple):
            yc, uc, vc = clip
            return (self._plane(yc, T, H, W, fh, fw),
                    self._plane(uc, T, H // 2, W // 2, (fh + 1) // 2, (fw + 1) // 2),
                    self._plane(vc, T, H // 2, W // 2, (fh + 1) // 2, (fw + 1) // 2))
        dtype = torch.uint8 if clip.dtype == np.uint8 else torch.float32
        return self._upload((T, 1, H, W, 3), dtype, self._filler(clip, T, H, W, fh, fw))

    def _plane(self, c: np.ndarray, T: int, h: int, w: int, ch: int, cw: int):
        return self._upload((T, 1, h, w), torch.uint8, self._filler(c, T, h, w, ch, cw))

    def _upload(self, shape, dtype: torch.dtype, fill) -> torch.Tensor:
        """fill(np_view) writes a new host tensor, which goes to the engine's
        device. On CUDA it is a pinned block of PyTorch's caching host
        allocator, reused only after its copy has completed."""
        buf = torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")
        fill(buf.numpy())
        return buf.to(self.device, non_blocking=True)

    @staticmethod
    def _filler(c: np.ndarray, T: int, h: int, w: int, ch: int, cw: int):
        t = c.shape[0]
        exact = t == T and ch == h and cw == w

        def fill(buf):
            if not exact:
                buf.fill(0)
            buf[:t, 0, :ch, :cw] = c
            if t < T:
                buf[t:, 0, :ch, :cw] = c[-1]

        return fill

    def _tokens(self, texts: Sequence[str]):
        """Token ids and mask (n, S) of every text, in one tokenizer call, on
        the device (through `_upload`)."""
        out = []
        for a in self.tokenizer(list(texts)):
            a = np.array(a)
            out.append(self._upload(a.shape, torch.from_numpy(a).dtype,
                                    lambda buf, a=a: np.copyto(buf, a)))
        return out

    # ---------------- per-video inference ----------------
    def infer_video(self, frames, text: str,
                    original_size: Optional[Tuple[int, int]] = None,
                    return_probs: bool = False, trajectory: str = "video",
                    return_boxes: bool = False):
        """frames: (T, h, w, 3) uint8 RGB (normalized on the device),
        float32 ImageNet-normalized, or a (y, u, v) tuple of uint8 YUV420p
        planes (converted and normalized on the device); resized, unpadded.

        trajectory='video': one query chosen from the whole-video mean score;
        'chunk': chosen again for every chunk.

        Returns (T, H_orig, W_orig) uint8 masks in {0, 1}, or float32
        probabilities with return_probs; with return_boxes, (masks, boxes)
        where boxes are (T, 4) xyxy pixels at the original size."""
        return self.infer_video_multi(frames, [text], original_size=original_size,
                                      return_probs=return_probs, trajectory=trajectory,
                                      return_boxes=return_boxes)[0]

    def infer_video_multi(self, frames, texts: Sequence[str],
                          original_size: Optional[Tuple[int, int]] = None,
                          return_probs: bool = False, trajectory: str = "video",
                          return_boxes: bool = False) -> List:
        """Every expression of one video over shared frames: the backbone
        runs once per chunk, the head once per chunk for each group of
        expressions (`head_groups`). Returns a list parallel to `texts` of
        infer_video-shaped results."""
        return self._collect_video(self._dispatch_video(
            frames, texts, original_size=original_size, return_probs=return_probs,
            trajectory=trajectory, return_boxes=return_boxes))

    def infer_videos(self, items, depth: int = 1):
        """Pipelined multi-video inference: yields infer_video_multi-shaped
        result lists in input order, queueing video i+depth's work before
        waiting for video i's masks. `items` is an iterable of dicts with
        keys frames, texts (+ optional original_size/return_probs/trajectory/
        return_boxes)."""
        pending = deque()
        for item in items:
            pending.append(self._dispatch_video(**item))
            if len(pending) > depth:
                yield self._collect_video(pending.popleft())
        while pending:
            yield self._collect_video(pending.popleft())

    @torch.no_grad()
    def _dispatch_video(self, frames, texts: Sequence[str],
                        original_size: Optional[Tuple[int, int]] = None,
                        return_probs: bool = False, trajectory: str = "video",
                        return_boxes: bool = False) -> dict:
        """Upload, run and finalize every chunk of one video; returns a handle
        for _collect_video. Queues device work only; never waits for it."""
        with span("soc.engine.dispatch"):
            handle = self._dispatch(frames, texts, original_size, return_probs, trajectory,
                                    return_boxes)
            self._submit(handle)
            return handle

    def _submit(self, handle: dict) -> None:
        """Queue `_unpack(handle)` on the engine's worker behind the handle's
        event; the handle gets `seen` (the event has completed) and `future`."""
        if self._worker is None:
            self._worker = _host_worker(self.device, "soc-engine-collector")
        seen = handle["seen"] = threading.Event()
        handle["future"] = self._worker.submit(_after_event, handle["event"], seen,
                                               _unpack, handle)
        # a worker whose initializer failed never runs the job: wake the wait all the same
        handle["future"].add_done_callback(lambda _: seen.set())

    def _dispatch(self, frames, texts, original_size, return_probs, trajectory,
                  return_boxes) -> dict:
        if trajectory not in ("video", "chunk"):
            raise ValueError(f"unknown trajectory: {trajectory!r} "
                             "(expected 'video' or 'chunk')")
        if (self.pixel_format == "yuv420" and isinstance(frames, np.ndarray)
                and frames.dtype == np.uint8):
            frames = rgb_to_yuv420(frames)
        yuv = isinstance(frames, (tuple, list))
        if yuv:
            frames = tuple(frames)
            if len(frames) != 3 or any(p.dtype != np.uint8 or p.ndim != 3 for p in frames):
                raise ValueError("YUV420 frames must be (y, u, v) uint8 planes (T, h, w)")
            T_total, fh, fw = frames[0].shape
        elif not isinstance(frames, np.ndarray) or frames.ndim != 4 \
                or frames.dtype not in (np.uint8, np.float32):
            raise ValueError("frames must be a (T, h, w, 3) uint8 or float32 array or "
                             "a (y, u, v) tuple of uint8 planes")
        else:
            T_total, fh, fw, _ = frames.shape
        H, W = pick_size_bucket(fh, fw, self.size_buckets)
        if yuv and (H % 2 or W % 2):
            raise ValueError(f"YUV420 input needs even size buckets, got ({H}, {W})")
        oh, ow = (int(s) for s in (original_size or (fh, fw)))
        chunk = max(self.time_buckets)
        ids = msk = None
        model = self.model

        # per chunk: [(score sum over real frames, logits, boxes) per text], t
        chunks = []
        for start in range(0, T_total, chunk):
            with span("soc.engine.upload"):
                if ids is None:
                    ids, msk = self._tokens(texts)
                if yuv:
                    clip = tuple(p[start:start + chunk] for p in frames)
                    t = clip[0].shape[0]
                else:
                    clip = frames[start:start + chunk]
                    t = clip.shape[0]
                T = pick_time_bucket(t, self.time_buckets)
                pixels = self._pixel_buffer(clip, T, H, W, fh, fw)
                pad = self._get_pad(T, H, W, fh, fw)
                if yuv:
                    pixels = _yuv420_to_normalized(*pixels, pad, self._mean, self._std)
                elif pixels.dtype == torch.uint8:
                    pixels = _normalize_u8_in_graph(pixels, pad, self._mean, self._std)
            feats = model.backbone_features(pixels, pad)
            outs = []
            for g in head_groups(len(texts), T):
                B = len(g)
                # the head's rows are b-major: each level's T rows once per expression
                feats_b = feats if B == 1 else [f.repeat(B, 1, 1, 1) for f in feats]
                scores, logits, boxes = _extract_outputs(model.head(
                    feats_b, pad.expand(T, B, H, W), ids[g.start:g.stop], msk[g.start:g.stop]))
                sums = scores[:t].sum(0)
                outs.extend((sums[b], logits[:, b], boxes[:, b]) for b in range(B))
                self.head_calls += 1
                self.head_expressions += B
            chunks.append((outs, t))

        with span("soc.engine.finalize"):
            stat = dict(H=H, W=W, fh=fh, fw=fw, oh=oh, ow=ow, want_probs=return_probs,
                        pack=self.pack_masks and not return_probs,
                        probs_dtype=self.probs_dtype)
            results = []
            for k in range(len(texts)):
                qs = _select_in_graph([outs[k][0] for outs, _ in chunks], trajectory)
                masks = torch.cat([_finalize_masks(outs[k][1], q, **stat)[:t]
                                   for (outs, t), q in zip(chunks, qs)])
                boxes = None
                if return_boxes:
                    boxes = _to_host(torch.cat(
                        [outs[k][2].index_select(1, q.view(1))[:t, 0].float()
                         for (outs, t), q in zip(chunks, qs)]))
                results.append((_to_host(masks), boxes))
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        return dict(results=results, event=event, oh=oh, ow=ow, pack=stat["pack"],
                    return_probs=return_probs, return_boxes=return_boxes)

    def _collect_video(self, handle: dict) -> List:
        """One dispatched video's results in the public contract, once the
        worker has them: `soc.engine.wait` covers this thread's wait until
        the worker has seen the video's event, `soc.engine.unpack` its wait
        for the unpacked result. An error of the worker's is raised here."""
        with span("soc.engine.collect"):
            self.collects += 1
            self.collects_ready += handle["future"].done()
            with span("soc.engine.wait"):
                handle["seen"].wait()
            with span("soc.engine.unpack"):
                return handle["future"].result()


def _unpack(handle: dict) -> List:
    """A video's fetched results -> the public contract: masks unpacked and
    cropped to the original width (or copied), probabilities to float32,
    boxes to xyxy pixels."""
    oh, ow = handle["oh"], handle["ow"]
    out = []
    for masks, boxes in handle["results"]:
        if handle["return_probs"]:
            m = _probs_to_host(masks)
        elif handle["pack"]:
            m = np.unpackbits(masks.numpy(), axis=-1)[:, :, :ow]
        else:
            m = masks.numpy().copy()
        if handle["return_boxes"]:
            out.append((m, _cxcywh_to_xyxy_pixels(boxes.numpy(), oh, ow)))
        else:
            out.append(m)
    return out


def _probs_to_host(probs: torch.Tensor) -> np.ndarray:
    """Fetched probabilities in their wire format (float32, bfloat16, or
    uint8 = prob * 255 rounded) -> a float32 array in [0, 1] of its own."""
    if probs.dtype == torch.uint8:
        return probs.numpy().astype(np.float32) / 255.0
    return probs.float().numpy().astype(np.float32, copy=True)


def _cxcywh_to_xyxy_pixels(boxes: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(T, 4) cxcywh normalized to the resized content -> xyxy pixels at the
    original size, clipped."""
    cx, cy, bw, bh = boxes.T
    xyxy = np.stack([(cx - bw / 2) * ow, (cy - bh / 2) * oh,
                     (cx + bw / 2) * ow, (cy + bh / 2) * oh], -1)
    xyxy[:, 0::2] = xyxy[:, 0::2].clip(0, ow)
    xyxy[:, 1::2] = xyxy[:, 1::2].clip(0, oh)
    return xyxy


class EnginePool:
    """One InferenceEngine per device, each with its own replica of the model.
    `devices=None` means every visible card; `[card0] * 4` puts four engines
    on one card. A pool of one engine is that engine alone, in this process,
    on `model` itself when the model already lives on that device (a deep
    copy otherwise). A pool of several runs every engine in a worker process
    of its own (started with `spawn`: CUDA forbids fork once it is
    initialised), on a copy of the model made there, and this process only
    feeds them: an engine queues thousands of small kernel launches per clip
    from Python, so engines on threads of one process contend for the
    interpreter lock (four cards ran at a quarter of one card's rate), and an
    engine left in this process would hold back the feeding of the others.

    What runs where: `run_videos_pipelined`'s item_fn and post_fn run in this
    process, and a worker runs only `infer_video_multi` on its engine (or
    `map_videos`'s fn). Frames and results cross as tensors in shared memory.
    A worker's kernel launch counts are added to this process's counters
    after each call. A worker that fails to start or to run, or dies, makes
    the call raise here with its traceback and closes the pool; nothing falls
    back to threads or to the CPU. `close()` (or leaving a `with` block) ends
    the workers; they also end with this process. The CUDA kernels are built
    here before the workers start, so that workers only load them. The JAX
    package's `_local_replica` (pulling the local shard out of parameters
    replicated over several hosts) has no counterpart: a torch model lives in
    one process, and its replicas are copies."""

    def __init__(self, model: torch.nn.Module, devices=None, **engine_kwargs):
        if devices is None:
            resolve_device(None)  # RuntimeError without CUDA
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("EnginePool needs at least one device")
        self._params_src = None
        self._local: Optional[InferenceEngine] = None  # the engine of a pool of one
        self.engines: List[Union[InferenceEngine, _EngineWorker]] = []
        if len(self.devices) == 1:
            own = _same_device(self.devices[0], next(model.parameters()).device)
            self._local = InferenceEngine(model if own else copy.deepcopy(model),
                                          device=self.devices[0], **engine_kwargs)
            self.engines.append(self._local)
            return
        if any(d.type == "cuda" for d in self.devices):
            from .ops import _build

            _build.build_all()
        # this process's share of torch's CPU threads, split between the workers:
        # more threads than cores stall every worker on the CPU
        threads = max(1, torch.get_num_threads() // len(self.devices))
        with self._closing_on_error():
            for d in self.devices:
                self.engines.append(_EngineWorker(model, d, engine_kwargs, threads))
            for w in self.engines:
                w.recv()  # "ready"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """End the worker processes (idempotent)."""
        for eng in self.engines:
            if isinstance(eng, _EngineWorker):
                eng.close()

    def update_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load `state_dict` (e.g. the trainer's current weights) into every
        replica, strictly: one transfer per worker; a no-op when it is the very
        object loaded last."""
        if state_dict is self._params_src:
            return
        self._params_src = state_dict
        if self._local is not None:
            self._local.model.load_state_dict(state_dict, strict=True)
            return
        with self._closing_on_error():
            for w in self.engines:
                w.send(("params", dict(state_dict)))
            for w in self.engines:
                w.recv()

    def map_videos(self, items: Sequence, fn) -> List:
        """fn(engine, item) -> result; results in input order. Item i goes to
        engine i % n, the same interleaved split as shard_videos. In a pool of
        several, `fn` runs in the workers, so it must be picklable (a
        module-level function) and so must the items; numpy arrays in them and
        in the results cross in shared memory."""
        if self._local is not None:
            with _on_device(self._local.device):
                return [fn(self._local, it) for it in items]
        n = len(self.engines)
        with self._closing_on_error():
            for i, item in enumerate(items):
                self.engines[i % n].send(("call", fn), item)
            return [self.engines[i % n].recv() for i in range(len(items))]

    @contextmanager
    def _closing_on_error(self):
        try:
            yield
        except BaseException:
            self.close()
            raise


def _on_device(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a and b name one device (a bare "cuda" is the current card)."""
    def index(d):
        return torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index
    return a.type == b.type and index(a) == index(b)


class _Shared:
    """A numpy array that crosses to or from a worker as a tensor in shared
    memory (copied in once, read there without a copy), into `t` when given
    (a buffer of the array's shape and dtype), else into new shared memory."""

    def __init__(self, a: np.ndarray, t: Optional[torch.Tensor] = None):
        self.t = _new_shared(a.shape, _TORCH_DTYPES[a.dtype.str[1:]]) if t is None else t
        self.t.numpy()[...] = a

    def array(self) -> np.ndarray:
        return self.t.numpy()


def _new_shared(shape, dtype: torch.dtype) -> torch.Tensor:
    """A tensor whose storage is made in shared memory (`share_memory_()` of
    a new tensor would first copy it there: twice the time per clip)."""
    numel = int(np.prod(shape))
    storage = torch.UntypedStorage._new_shared(max(numel * dtype.itemsize, 1))
    return torch.empty(0, dtype=dtype).set_(storage)[:numel].view(tuple(shape))


_TORCH_DTYPES = {"u1": torch.uint8, "b1": torch.bool, "f4": torch.float32, "f8": torch.float64,
                 "i4": torch.int32, "i8": torch.int64}


def _to_wire(obj, buffer=None):
    """numpy arrays (of the dtypes the engine takes and returns) inside
    lists, tuples and dicts -> _Shared, each in `buffer(shape, dtype)` when
    given."""
    if isinstance(obj, np.ndarray) and obj.dtype.str[1:] in _TORCH_DTYPES:
        return _Shared(obj, buffer and buffer(obj.shape, _TORCH_DTYPES[obj.dtype.str[1:]]))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_wire(o, buffer) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_wire(v, buffer) for k, v in obj.items()}
    return obj


def _from_wire(obj, keep: Optional[deque] = None):
    """_Shared -> numpy views of their shared memory; their tensors are
    appended to `keep` when given."""
    if isinstance(obj, _Shared):
        if keep is not None:
            keep.append(obj.t)
        return obj.array()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_wire(o, keep) for o in obj)
    if isinstance(obj, dict):
        return {k: _from_wire(v, keep) for k, v in obj.items()}
    return obj


def _kernel_counters():
    """(function, attribute) of every kernel launch and plain-call counter."""
    from .ops import layer_norm, ms_deform_attn, window_attention, window_attention_torch

    return [(ms_deform_attn, a) for a in ("launches", "plain_calls", "bwd_launches",
                                          "plain_bwd_calls")] + [
        (window_attention, "launches"), (window_attention, "plain_calls"),
        (window_attention_torch, "calls"), (layer_norm, "launches"),
        (layer_norm, "plain_calls")]


class _EngineWorker:
    """One engine in a worker process: a request queue in, a reply queue out
    (torch.multiprocessing: tensors cross in shared memory, CUDA tensors by
    IPC), answered in order. `recv` raises the worker's error, or a
    RuntimeError once the process has died.

    The arrays of a request (`send(msg, arrays)`) go into shared buffers
    this object keeps and reuses once the request's reply has come: making
    new shared memory for each 16 x 360 x 640 clip's frames took the caller
    about 29 ms a clip on the card machine (8 ms with reuse), too slow to
    feed four cards."""

    POLL_S = 1.0
    KEEP = 4  # free buffers kept per (shape, dtype)

    def __init__(self, model: torch.nn.Module, device: torch.device, engine_kwargs: dict,
                 threads: int):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.device = device
        self.inbox, self.outbox = ctx.Queue(), ctx.Queue()
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._held: deque = deque()  # per request awaiting its reply: its buffers
        self.proc = ctx.Process(
            target=_worker_main, daemon=True, name=f"engine-{device}",
            args=(str(device), engine_kwargs, threads, self.inbox, self.outbox))
        self.proc.start()
        self.send(("model", model))

    def send(self, msg, arrays=None) -> None:
        """Queue request `msg` (None, ("end",) or one that is answered), with
        `arrays` (numpy arrays inside lists, tuples and dicts) appended to it
        in shared buffers."""
        if not self.proc.is_alive():
            raise RuntimeError(f"the engine worker on {self.device} is not running "
                               f"(exit code {self.proc.exitcode})")
        held = []
        if arrays is not None:
            msg = msg + (_to_wire(arrays, lambda shape, dtype: self._buffer(shape, dtype, held)),)
        self.inbox.put(msg)
        if msg is not None and msg[0] != "end":
            self._held.append(held)

    def _buffer(self, shape, dtype, held: list) -> torch.Tensor:
        free = self._free.get((tuple(shape), dtype))
        t = free.pop() if free else _new_shared(shape, dtype)
        held.append(t)
        return t

    def recv(self):
        """The next reply: its result, after adding the worker's kernel counts
        to this process's counters."""
        while True:
            try:
                kind, payload, counts = self.outbox.get(timeout=self.POLL_S)
                break
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError(f"the engine worker on {self.device} died (exit code "
                                       f"{self.proc.exitcode})") from None
        for (fn, attr), c in zip(_kernel_counters(), counts):
            setattr(fn, attr, getattr(fn, attr) + c)
        for t in self._held.popleft():  # the worker is done with the request's arrays
            free = self._free.setdefault((tuple(t.shape), t.dtype), [])
            if len(free) < self.KEEP:
                free.append(t)
        if kind == "error":
            raise RuntimeError(f"the engine worker on {self.device} failed:\n{payload}")
        return _from_wire(payload)

    def close(self) -> None:
        if self.proc.is_alive():
            try:
                self.inbox.put(None)
            except (OSError, ValueError):
                pass
            self.proc.join(10)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)
        for q in (self.inbox, self.outbox):
            q.cancel_join_thread()
            q.close()


def _worker_main(device: str, engine_kwargs: dict, threads: int, inbox, outbox):
    """A worker's loop: build the engine on `device` on a copy of the model
    that arrives first, ("model", model), reply "ready", then answer each
    request in order until None arrives or the parent process is gone:
    ("params", state_dict), ("call", fn, item), ("video", kwargs) (a run of
    videos, pipelined at depth 1 through infer_videos, ended by ("end",)).
    Every reply carries the kernel counts of its work."""
    import multiprocessing

    counters = _kernel_counters()
    parent = multiprocessing.parent_process()
    # the caller reuses its request buffers; while a buffer's storage lives here, a request
    # that brings it again maps to it (torch's shared-storage cache) instead of mapping and
    # faulting in its pages anew
    mapped = deque(maxlen=4 * (WORKER_AHEAD + 1 + _EngineWorker.KEEP))

    def reply(kind, payload):
        counts = [getattr(fn, a) for fn, a in counters]
        for fn, a in counters:
            setattr(fn, a, 0)
        outbox.put((kind, payload, counts))

    def get():
        while True:
            try:
                return inbox.get(timeout=_EngineWorker.POLL_S)
            except queue.Empty:
                if parent is not None and not parent.is_alive():
                    return None

    try:
        torch.set_num_threads(threads)
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        msg = get()
        if msg is None:
            return
        # a replica of its own on this device, never the sender's memory (shared
        # memory, or CUDA IPC on the sender's card)
        engine = InferenceEngine(copy.deepcopy(msg[1].to(dev)), device=dev, **engine_kwargs)
        del msg
    except BaseException:
        reply("error", traceback.format_exc())
        return
    reply("ready", None)
    msg = get()

    def videos():  # the run of ("video", kwargs) requests from `msg` on
        nonlocal msg
        while msg is not None and msg[0] == "video":
            yield _from_wire(msg[1], mapped)
            msg = get()

    while msg is not None:
        try:
            if msg[0] == "params":
                engine.model.load_state_dict(msg[1], strict=True)
                reply("ok", None)
            elif msg[0] == "call":
                reply("ok", _to_wire(msg[1](engine, _from_wire(msg[2], mapped))))
            elif msg[0] == "video":
                for res in engine.infer_videos(videos(), depth=1):
                    reply("ok", _to_wire(res))
                continue  # msg is the request after the run ("end" or None)
        except Exception:
            reply("error", traceback.format_exc())
        msg = get()


# videos sent to a worker beyond the one whose result is read next: a worker dispatches its
# next video before it hands back the last one's result (depth 1), and with one video ahead it
# waited for the caller's turn to send it (two worker processes on one card ran at 0.46x two
# independent processes there)
WORKER_AHEAD = 2


def run_videos_pipelined(engine_or_pool, items: Sequence, item_fn, post_fn) -> List:
    """Depth-1 pipelined per-video work over one InferenceEngine or an
    EnginePool (item i -> engine i % n). Per engine, video i+1's work is
    queued before video i's masks are fetched (InferenceEngine.infer_videos),
    so the next item's decode inside item_fn and this item's PNG writes
    inside post_fn overlap the device.

    item_fn(item) -> kwargs of infer_video_multi (side data for post_fn may
    be stashed on the item); post_fn(item, results) -> stored value. Both run
    in the calling process, one item at a time; a pool's workers run only
    infer_video_multi. Returns post_fn's values in input order."""
    pool = engine_or_pool if isinstance(engine_or_pool, EnginePool) else None
    engine = engine_or_pool if pool is None else pool._local
    if engine is not None:
        with _on_device(engine.device):
            kwargs = (item_fn(item) for item in items)
            return [post_fn(item, res)
                    for item, res in zip(items, engine.infer_videos(kwargs, depth=1))]
    workers, results = pool.engines, [None] * len(items)
    pending = [deque() for _ in workers]  # item indices sent, results not yet read

    def finish(e: int) -> None:
        i = pending[e].popleft()
        results[i] = post_fn(items[i], workers[e].recv())

    with pool._closing_on_error():
        for i, item in enumerate(items):
            e = i % len(workers)
            workers[e].send(("video",), item_fn(item))
            pending[e].append(i)
            if len(pending[e]) > WORKER_AHEAD:
                finish(e)
        for e, w in enumerate(workers):
            if pending[e]:
                w.send(("end",))
        while any(pending):
            for e in range(len(workers)):
                if pending[e]:
                    finish(e)
    return results


def shard_videos(items: List, num_shards: Optional[int] = None,
                 shard_id: Optional[int] = None) -> List:
    """This process's interleaved share of `items`: rank and world size from
    torch.distributed when it is initialized, else (0, 1)."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    num_shards = num_shards or (dist.get_world_size() if up else 1)
    shard_id = shard_id if shard_id is not None else (dist.get_rank() if up else 0)
    return items[shard_id::num_shards]


def save_ytvos_predictions(preds_by_video: List[Dict], out_dir: str):
    """Per-frame PNG masks in the competition layout
    Annotations/<video>/<exp>/<frame>.png (reference infer_refytb.py:230-277)."""
    from PIL import Image

    out = Path(out_dir)
    for pred in preds_by_video:
        d = out / "Annotations" / pred["video_id"] / pred["exp_id"]
        d.mkdir(parents=True, exist_ok=True)
        for frame_idx, mask in zip(pred["frame_indices"], pred["pred_masks"]):
            Image.fromarray((mask * 255).astype(np.uint8)).save(d / f"{frame_idx}.png")


def zip_submission(out_dir: str, zip_name: str = "submission.zip"):
    """Zip Annotations/ for the competition server (reference trainer.py:344-350)."""
    out = Path(out_dir)
    zpath = out / zip_name
    with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as zf:
        for p in sorted((out / "Annotations").rglob("*.png")):
            zf.write(p, p.relative_to(out))
    return str(zpath)


def group_davis_annotator_order(items: List) -> List:
    """Reorder a video's expressions (sorted by exp id, object-major:
    exp = obj * 4 + anno) into annotator-major order [a0o0, a0o1, ..., a1o0,
    ...], so a sequential consumer groups each annotation variant's objects
    together (reference infer_davis.py:199)."""
    num_obj, rem = divmod(len(items), 4)
    if rem:
        raise ValueError(f"expected 4 annotation variants per object, got {len(items)} "
                         "expressions")
    return [items[obj * 4 + anno] for anno in range(4) for obj in range(num_obj)]


def merge_davis_annotator(prob_masks: List[np.ndarray]) -> np.ndarray:
    """Per-object probability masks (a list over objects of (T, H, W) in
    [0, 1]) -> index masks, with a 0.1 background channel (reference
    infer_davis.py:263-275)."""
    anno = np.stack(prob_masks)
    anno = np.where(anno < 0.5, 0.0, anno)
    background = 0.1 * np.ones((1,) + anno.shape[1:], anno.dtype)
    return np.argmax(np.concatenate([background, anno], 0), 0).astype(np.uint8)


def save_davis_annotator_masks(index_masks: np.ndarray, out_dir: str,
                               frame_names: Sequence[str]):
    from PIL import Image

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for f, name in enumerate(frame_names):
        img = Image.fromarray(index_masks[f])
        img.putpalette(DAVIS_PALETTE + bytes(768 - len(DAVIS_PALETTE)))
        img.save(out / f"{name}.png")
