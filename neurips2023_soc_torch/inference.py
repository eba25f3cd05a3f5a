"""Whole-video referring inference engine (torch twin of
neurips2023_soc_tpu/inference.py:InferenceEngine).

Per video: frames are copied into engine-owned staging buffers and uploaded;
uint8 frames are normalized on the device; the backbone runs once per chunk
and the text-dependent head once per expression; trajectory selection (the
argmax of the whole-video score sum, or per chunk) and the finalize step
(gather the chosen query, upsample to the bucket, crop, resize to the
original size, sigmoid, threshold, bit-pack) all run on the device. Only the
final masks (and, on request, the chosen (T, 4) boxes) come back.

Nothing in a dispatch waits for the device: uploads go from pinned buffers
with non_blocking copies, the results are copied back the same way into
pinned host buffers, and a CUDA event recorded behind those copies is the one
thing `_collect_video` waits on. `infer_videos` therefore queues video i+1's
work before it waits for video i's masks. A staging buffer is handed out
again only after the event behind its last upload has completed, and the
caller's frames are copied, never aliased, so a caller may reuse its arrays as
soon as a dispatch returns.

Time buckets reach 64 frames, so typical Ref-YouTube-VOS videos run in one
forward and VOC clusters over the whole video; longer videos are chunked.

Not ported yet: YUV420 input, the probability wire formats, EnginePool,
shard_videos and the YTVOS/DAVIS save helpers.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data.collate import IMAGENET_MEAN, IMAGENET_STD
from .device import resolve_device
from .models.text_encoder import build_tokenizer
from .ops import resize_bilinear
from .utils.padded import pick_size_bucket, pick_time_bucket

DEFAULT_TIME_BUCKETS = (8, 16, 32, 64)


def _normalize_u8_in_graph(pixels: torch.Tensor, pad_mask: torch.Tensor,
                           mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """uint8 (T, B, H, W, 3) -> ImageNet-normalized float32, zeroed on
    padding; the same arithmetic as the dataset's host normalize."""
    x = (pixels.float() / 255.0 - mean) / std
    return x.masked_fill(pad_mask[..., None], 0.0)


def _finalize_masks(logits: torch.Tensor, q: torch.Tensor, *, H: int, W: int,
                    fh: int, fw: int, oh: int, ow: int, want_probs: bool,
                    pack: bool) -> torch.Tensor:
    """Gather query `q`'s stride-4 logits (T, Nq, h4, w4), upsample to the
    (H, W) bucket, crop to the resized content, resize to the original frame
    size, sigmoid, and threshold at 0.5 unless probabilities are wanted. With
    `pack`, masks are bit-packed 8 pixels/byte along width (np.unpackbits
    layout, MSB first)."""
    sel = logits.index_select(1, q.view(1))[:, 0].float()
    up = resize_bilinear(sel[..., None], H, W)[..., 0]
    content = up[:, :fh, :fw]
    if (oh, ow) != (fh, fw):
        content = resize_bilinear(content[..., None], oh, ow)[..., 0]
    prob = torch.sigmoid(content.clamp(-30.0, 30.0))
    if want_probs:
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
    """Last emitted layer, batch entry 0: per-query scores (T, Nq) (max over
    classes), bf16 stride-4 mask logits (T, Nq, h, w), boxes (T, Nq, 4)."""
    scores = torch.sigmoid(out["pred_cls"][-1].float())[:, 0].amax(-1)
    return (scores, out["pred_masks"][-1][:, 0].to(torch.bfloat16),
            out["pred_boxes"][-1][:, 0])


def _select_in_graph(score_sums: List[torch.Tensor], trajectory: str) -> List[torch.Tensor]:
    """Chosen query per chunk from each chunk's per-query score sum over its
    real frames, as device scalars (no host round trip). 'video': the argmax
    of the whole-video sum (== of the whole-video mean) for every chunk;
    'chunk': each chunk's own argmax."""
    if trajectory == "video":
        q = torch.argmax(torch.stack(score_sums).sum(0))
        return [q] * len(score_sums)
    return [torch.argmax(s) for s in score_sums]


class _Staging:
    """Engine-owned host buffers for uploads. On CUDA they are pinned, and a
    buffer is reused only after the event recorded behind its last upload has
    completed; on the CPU every upload gets a fresh buffer."""

    MAX_PER_SHAPE = 4

    def __init__(self, device: torch.device):
        self.device = device
        self._slots: List[list] = []  # [buffer, event or None]

    def upload(self, shape, dtype: torch.dtype, fill) -> torch.Tensor:
        """fill(np_view) writes the content into the staging buffer; returns
        the tensor on the engine's device."""
        if self.device.type != "cuda":
            buf = torch.empty(shape, dtype=dtype)
            fill(buf.numpy())
            return buf
        same = [s for s in self._slots
                if s[0].shape == torch.Size(shape) and s[0].dtype == dtype]
        slot = next((s for s in same if s[1] is None or s[1].query()), None)
        if slot is None and len(same) >= self.MAX_PER_SHAPE:
            slot = same[0]
            slot[1].synchronize()
        if slot is None:
            slot = [torch.empty(shape, dtype=dtype, pin_memory=True), None]
            self._slots.append(slot)
        fill(slot[0].numpy())
        out = slot[0].to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        slot[1] = event
        return out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue a device->host copy into pinned memory (no wait)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, text_encoder_type: str = "roberta-base",
                 text_bucket: int = 32, time_buckets: Optional[Sequence[int]] = None,
                 size_buckets=((360, 640),), pack_masks: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        """Runs `model` (an SOC) on `device`, the CUDA card when None
        (RuntimeError without CUDA). pack_masks bit-packs thresholded masks
        on the device (8 pixels/byte) and unpacks them after the fetch."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = build_tokenizer(text_encoder_type, text_bucket)
        self.time_buckets = tuple(time_buckets or DEFAULT_TIME_BUCKETS)
        self.size_buckets = tuple(size_buckets)
        self.pack_masks = pack_masks
        self._staging = _Staging(self.device)
        self._pad_cache: Dict[tuple, torch.Tensor] = {}
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

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

    def _pixel_buffer(self, clip: np.ndarray, T: int, H: int, W: int,
                      fh: int, fw: int) -> torch.Tensor:
        """Bucket-padded (T, 1, H, W, 3) pixels on the device. The clip is
        copied into an engine-owned buffer; padded frames repeat the last
        frame's content."""
        t = clip.shape[0]
        exact = t == T and fh == H and fw == W

        def fill(buf):
            if not exact:
                buf.fill(0)
            buf[:t, 0, :fh, :fw] = clip
            if t < T:
                buf[t:, 0, :fh, :fw] = clip[-1]

        dtype = torch.uint8 if clip.dtype == np.uint8 else torch.float32
        return self._staging.upload((T, 1, H, W, 3), dtype, fill)

    def _tokens(self, text: str):
        """Token ids and mask (1, S) on the device. On CUDA they ride pinned
        blocks of PyTorch's host allocator, which reuses a block only after
        its copy has completed."""
        out = []
        for a in self.tokenizer([text]):
            t = torch.from_numpy(np.array(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    # ---------------- per-video inference ----------------
    def infer_video(self, frames: np.ndarray, text: str,
                    original_size: Optional[Tuple[int, int]] = None,
                    return_probs: bool = False, trajectory: str = "video",
                    return_boxes: bool = False):
        """frames: (T, h, w, 3) uint8 RGB (normalized on the device) or
        float32 ImageNet-normalized, resized and unpadded.

        trajectory='video': one query chosen from the whole-video mean score;
        'chunk': chosen again for every chunk.

        Returns (T, H_orig, W_orig) uint8 masks in {0, 1}, or float32
        probabilities with return_probs; with return_boxes, (masks, boxes)
        where boxes are (T, 4) xyxy pixels at the original size."""
        return self.infer_video_multi(frames, [text], original_size=original_size,
                                      return_probs=return_probs, trajectory=trajectory,
                                      return_boxes=return_boxes)[0]

    def infer_video_multi(self, frames: np.ndarray, texts: Sequence[str],
                          original_size: Optional[Tuple[int, int]] = None,
                          return_probs: bool = False, trajectory: str = "video",
                          return_boxes: bool = False) -> List:
        """Every expression of one video over shared frames: the backbone
        runs once per chunk, the head once per expression. Returns a list
        parallel to `texts` of infer_video-shaped results."""
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
    def _dispatch_video(self, frames: np.ndarray, texts: Sequence[str],
                        original_size: Optional[Tuple[int, int]] = None,
                        return_probs: bool = False, trajectory: str = "video",
                        return_boxes: bool = False) -> dict:
        """Upload, run and finalize every chunk of one video; returns a handle
        for _collect_video. Queues device work only; never waits for it."""
        if trajectory not in ("video", "chunk"):
            raise ValueError(f"unknown trajectory: {trajectory!r} "
                             "(expected 'video' or 'chunk')")
        if not isinstance(frames, np.ndarray) or frames.ndim != 4 \
                or frames.dtype not in (np.uint8, np.float32):
            raise ValueError("frames must be a (T, h, w, 3) uint8 or float32 array")
        T_total, fh, fw, _ = frames.shape
        H, W = pick_size_bucket(fh, fw, self.size_buckets)
        oh, ow = (int(s) for s in (original_size or (fh, fw)))
        chunk = max(self.time_buckets)
        toks = [self._tokens(t) for t in texts]
        model = self.model

        # per chunk: [(score sum over real frames, logits, boxes) per text], t
        chunks = []
        for start in range(0, T_total, chunk):
            clip = frames[start:start + chunk]
            t = clip.shape[0]
            T = pick_time_bucket(t, self.time_buckets)
            pixels = self._pixel_buffer(clip, T, H, W, fh, fw)
            pad = self._get_pad(T, H, W, fh, fw)
            if pixels.dtype == torch.uint8:
                pixels = _normalize_u8_in_graph(pixels, pad, self._mean, self._std)
            feats = model.backbone_features(pixels, pad)
            outs = []
            for ids, msk in toks:
                scores, logits, boxes = _extract_outputs(model.head(feats, pad, ids, msk))
                outs.append((scores[:t].sum(0), logits, boxes))
            chunks.append((outs, t))

        stat = dict(H=H, W=W, fh=fh, fw=fw, oh=oh, ow=ow, want_probs=return_probs,
                    pack=self.pack_masks and not return_probs)
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
        return dict(results=results, event=event, oh=oh, ow=ow,
                    return_probs=return_probs, return_boxes=return_boxes)

    def _collect_video(self, handle: dict) -> List:
        """Wait for one dispatched video's copies and convert to the public
        contract."""
        if handle["event"] is not None:
            handle["event"].synchronize()
        oh, ow = handle["oh"], handle["ow"]
        out = []
        for masks, boxes in handle["results"]:
            m = masks.numpy()
            if handle["return_probs"]:
                m = m.astype(np.float32, copy=True)
            elif self.pack_masks:
                m = np.unpackbits(m, axis=-1)[:, :, :ow]
            else:
                m = m.copy()
            if handle["return_boxes"]:
                out.append((m, _cxcywh_to_xyxy_pixels(boxes.numpy(), oh, ow)))
            else:
                out.append(m)
        return out


def _cxcywh_to_xyxy_pixels(boxes: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(T, 4) cxcywh normalized to the resized content -> xyxy pixels at the
    original size, clipped."""
    cx, cy, bw, bh = boxes.T
    xyxy = np.stack([(cx - bw / 2) * ow, (cy - bh / 2) * oh,
                     (cx + bw / 2) * ow, (cy + bh / 2) * oh], -1)
    xyxy[:, 0::2] = xyxy[:, 0::2].clip(0, ow)
    xyxy[:, 1::2] = xyxy[:, 1::2].clip(0, oh)
    return xyxy
