"""Parity of the port's large modules against the JAX package, on the CPU in
float32 at small sizes (atol = rtol = 1e-4): Video-Swin (shifted and clamped
windows, the 2D Swin variant; the port's `attn_impl="pallas"` backbone, K3's
plain version on the CPU, against the same JAX model built with the default
`xla`), RoBERTa-tiny and VOC at batch 2. The flax parameters are carried over
through the port's own key mapping."""
import numpy as np
import pytest
import torch

import neurips2023_soc_tpu.models.text_encoder as jte
import neurips2023_soc_tpu.models.video_swin as jvs
import neurips2023_soc_tpu.models.voc as jvoc
import neurips2023_soc_torch.models.text_encoder as tte
import neurips2023_soc_torch.models.video_swin as tvs
import neurips2023_soc_torch.models.voc as tvoc

from torch_port_helpers import apply_jax, close, init_jax, load, soc_state_dict, t
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)


def _check_swin(name, video):
    jm = jvs.build_video_swin(name)
    params = init_jax(jm, video)
    want = apply_jax(jm, params, video)
    sd = soc_state_dict(params, "backbone", "backbone.0.body.")
    for impl in ("xla", "pallas"):
        got = load(tvs.build_video_swin(name, attn_impl=impl), sd)(t(video))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            close(g, w)


def _case_video_swin_t():
    # T=3 < 8 clamps the temporal window (shift 0); 10x14 tokens pad to 14x14
    # with shift 3; the 5x7 stage clamps both spatial windows
    _check_swin("video-swin-t", np.random.RandomState(0).randn(2, 3, 40, 56, 3)
                .astype(np.float32))


def _case_swin_2d():
    _check_swin("swin-t", np.random.RandomState(1).randn(1, 2, 36, 60, 3)
                .astype(np.float32))


def _case_roberta_tiny():
    rng = np.random.RandomState(2)
    ids = rng.randint(3, 1000, size=(2, 9)).astype(np.int32)
    msk = np.ones((2, 9), np.int32)
    msk[1, 6:] = 0
    cfg = jte.ROBERTA_CONFIGS["roberta-tiny"]
    jm = jte.RobertaEncoder(cfg)
    params = init_jax(jm, ids, msk)
    want = apply_jax(jm, params, ids, msk)
    tm = load(tte.RobertaEncoder(tte.ROBERTA_CONFIGS["roberta-tiny"]),
              soc_state_dict(params, "text_encoder", "text_encoder."))
    got = tm(t(ids), t(msk))
    close(got[0], want[0])
    close(got[1], want[1])


def _check_voc(window_size, T):
    rng = np.random.RandomState(3 + window_size)
    Lyr, B, Nq, C = 2, 2, 4, 32
    fq = rng.randn(Lyr, T, B, Nq, C).astype(np.float32)
    lang = rng.randn(B, C).astype(np.float32)
    kw = dict(input_dim=C, window_size=window_size, num_frame_queries=Nq,
              num_queries=Nq, num_heads=4, dim_feedforward=64, enc_layers=2,
              dec_layers=2)
    jm = jvoc.VOC(dropout=0.0, **kw)
    params = init_jax(jm, fq, lang)
    want = apply_jax(jm, params, fq, lang)
    tm = load(tvoc.VOC(**kw), soc_state_dict(params, "voc", "voc."))
    got = tm(t(fq), t(lang))
    assert got.shape == (1, B, Nq, C)
    close(got, want)


def _case_voc_full_b2():
    _check_voc(0, 3)


def _case_voc_windowed_b2():
    _check_voc(2, 5)  # T=5 pads to 6: 3 windows, the last half padding


def test_tokenizers_match():
    texts = ["a person riding a bike", "the dog"]
    for name in ("roberta-tiny", "roberta-base"):
        for a, b in zip(tte.build_tokenizer(name, 8)(texts),
                        jte.build_tokenizer(name, 8)(texts)):
            np.testing.assert_array_equal(a, b)


CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
         if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_parity(case):
    with torch.no_grad():
        CASES[case]()
