"""The reference against the port's plain path on the CPU with the 2D image
Swin backbone (window 1 x 7 x 7, per-stage output norms): the comparisons of
test_bench_reference.py (the SOC forward, the engine's masks) on the tiny
configuration with `backbone: swin-t`, from the same seeded weights."""
import json
from pathlib import Path

import pytest
import torch

from benchmark.reference import build_reference
from benchmark.weights import make_weights

from .test_bench_reference import (SEED, test_engine_masks_equal_the_reference,  # noqa: F401
                                   test_soc_forward_equals_the_ports,
                                   test_weights_cover_the_programs_state_dict)

HERE = Path(__file__).resolve().parent
CFG = json.loads((HERE / "fixtures/tiny-soc-swin2d.json").read_text())


@pytest.fixture(scope="module")
def pair():
    from neurips2023_soc_torch.config import Config
    from neurips2023_soc_torch.models import build_model

    torch.manual_seed(0)
    weights = make_weights(CFG, SEED, "cpu")
    prog = build_model(Config(CFG), device="cpu")
    prog.load_state_dict(weights, strict=True)
    assert prog.backbone[0].body.num_out_norms == 4
    ref = build_reference(CFG, torch.float32, "cpu")
    ref.load_state_dict(weights, strict=True)
    return prog.eval(), ref.eval()
