"""neurips2023_soc_torch — the PyTorch and CUDA port of neurips2023_soc_tpu,
for NVIDIA Hopper (H100).

The layout mirrors the JAX package, module for module:
  ops/        — MSDA (plain versions + hand-written CUDA kernels), exact resizes,
                window attention
  csrc/       — CUDA C++ kernel sources, built with nvcc at first use
  utils/      — box math, size/time buckets, metric logging, prefetch
  models/     — Video-Swin, RoBERTa, fusion, deformable transformer, VOC, heads
  losses/     — Hungarian matcher (exact on-device LAP), criterion, mask losses
  training/   — optax-semantics optimizer, train step, checkpoints, Trainer
  data/       — synthetic dataset and collation
  config.py   — YAML config loading (the same configs/*.yaml)
  convert.py  — JAX parameter tree -> this package's state_dict
  inference.py — whole-video referring inference engine

Entry points run on the CUDA card unless the caller passes device="cpu".
The package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
