"""bench_torch.py's measurement functions on the tiny model on the CPU:
every field present, finite and positive. The numbers themselves are CPU
times and mean nothing; bench_torch.py measures only on the card and raises
without one."""
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
from neurips2023_soc_torch.models.common import init_weights  # noqa: E402
from neurips2023_soc_torch.models.soc import SOC  # noqa: E402
from torch_port_helpers import torch_threads_per_worker  # noqa: E402,F401 (autouse)

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")
SIZE = dict(H=48, W=64)
TEXT = dict(text_encoder_type="roberta-tiny", text_bucket=8)


def _model():
    return init_weights(SOC(**KW), torch.Generator().manual_seed(0)).eval()


def _positive(d):
    for k, v in d.items():
        if isinstance(v, dict):
            _positive(v)
        elif isinstance(v, list):
            assert v and all(math.isfinite(x) and x > 0 for x in v), k
        else:
            assert math.isfinite(v) and v > 0, (k, v)


def _spreads(r, keys):
    for k in keys:
        assert set(r[k]) == {"median", "min", "max"}, k
        assert r[k]["min"] <= r[k]["median"] <= r[k]["max"], k


def test_measure_device_and_engine_fields():
    model = _model()
    dev = bench_torch.counted(bench_torch.measure_device, model, 2, 2, **SIZE, **TEXT)
    _spreads(dev, ("sync_fps", "pipelined_fps"))
    assert dev["launches"] == dict(k1=0, k2=0, k3=0)  # the CPU runs the plain versions
    _positive({k: v for k, v in dev.items() if k != "launches"})
    for fmt, expressions in (("uint8", 1), ("yuv420", 1), ("uint8", 3)):
        eng = bench_torch.measure_engine(model, 2, 2, 2, fmt=fmt, expressions=expressions,
                                         **SIZE, **TEXT)
        _spreads(eng, ("sync_fps", "pipelined_fps"))
        _positive(eng)


def test_measure_train_fields():
    r = bench_torch.measure_train(_model(), 2, 1, 2, **SIZE)
    _spreads(r, ("step_ms",))
    assert len(r["losses"]) == 2 and "peak_gib" not in r  # no device memory on the CPU
    _positive(r)


def test_main_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_torch.main()
