"""neurips2023_soc_torch — the PyTorch and CUDA port of neurips2023_soc_tpu,
for NVIDIA Hopper (H100).

The layout mirrors the JAX package, module for module:
  ops/        — MSDA and Swin window attention (plain versions + hand-written
                CUDA kernels K1, K2, K3), exact resizes
  csrc/       — CUDA C++ kernel sources, built with nvcc at first use
  utils/      — box math, size/time buckets, metric logging, prefetch, overlays
  models/     — Video-Swin, RoBERTa, fusion, deformable transformer, VOC, heads
  losses/     — Hungarian matcher (exact on-device LAP), criterion, mask losses
  training/   — optax-semantics optimizer, train step, checkpoints, Trainer
  data/       — synthetic dataset, collation, Ref-YouTube-VOS, Ref-DAVIS-17 (and its
                converter), video transforms, RefCOCO ground truth
  parallel/   — torch.distributed start-up, rank-0, barrier and object gather helpers
  evaluation/ — numpy metrics: COCO RLE, COCO mask mAP and P@K, RefExp box recall,
                DAVIS J and F
  cli/        — infer_refytb, infer_davis, eval_davis, demo_video, predict
  config.py   — YAML config loading (the same configs/*.yaml) and CLI flags
  convert.py  — JAX parameter tree -> this package's state_dict
  inference.py — whole-video referring inference engine, EnginePool, save helpers
  evaluators.py — A2D/JHMDB and RefCOCO evaluators, Ref-YouTube-VOS valid-set
                submission, `-rm pred` overlays (models/postprocessing.py beneath)

Entry points run on the CUDA card unless the caller passes device="cpu".
The package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
