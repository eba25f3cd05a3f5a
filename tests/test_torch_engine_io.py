"""The engine's wire formats and multi-video plumbing in the port, against
the JAX package's functions where they exist: YUV420 planes (host
conversion, exact; device decode at 1e-6), the three probability formats of
return_probs (float32 at 1e-6, bfloat16 and uint8 within one rounding step,
on fewer than 1 % of the pixels), EnginePool and run_videos_pipelined over CPU devices, sharding,
the YTVOS/DAVIS save helpers (byte-identical files), the config CLI flags
and the single-process multihost no-ops."""
import argparse
import copy
import time
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neurips2023_soc_tpu.inference as jinf
from neurips2023_soc_torch import inference as tinf
from neurips2023_soc_torch.config import add_config_args, config_from_args
from neurips2023_soc_torch.data.collate import IMAGENET_MEAN, IMAGENET_STD
from neurips2023_soc_torch.models.common import init_weights
from neurips2023_soc_torch.models.soc import SOC
from neurips2023_soc_torch.parallel import barrier, initialize_distributed, is_main_process
from neurips2023_soc_tpu.config import add_config_args as jax_add_config_args
from neurips2023_soc_tpu.config import config_from_args as jax_config_from_args
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

KW = dict(backbone_name="video-swin-t", d_model=64, num_queries=5, dim_feedforward=128,
          enc_layers=1, dec_layers=2, voc_enc_layers=1, voc_dec_layers=1,
          text_encoder_type="roberta-tiny")
ENGINE = dict(text_encoder_type="roberta-tiny", text_bucket=8, size_buckets=((48, 64),),
              time_buckets=(4,))


def _frames(seed, t=4, h=40, w=56):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (t, h // 4, w // 4, 3)).astype(np.float32)
    frames = np.kron(base, np.ones((1, 4, 4, 1), np.float32))
    return np.clip(frames + rng.randn(*frames.shape) * 8, 0, 255).astype(np.uint8)


def test_rgb_to_yuv420_equals_jax():
    frames = np.random.RandomState(0).randint(0, 256, (2, 7, 9, 3)).astype(np.uint8)
    for got, want in zip(tinf.rgb_to_yuv420(frames), jinf.rgb_to_yuv420(frames)):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_yuv420_to_normalized_matches_jax():
    rng = np.random.RandomState(1)
    y = rng.randint(0, 256, (2, 1, 8, 12)).astype(np.uint8)
    u, v = (rng.randint(0, 256, (2, 1, 4, 6)).astype(np.uint8) for _ in range(2))
    pad = np.zeros((2, 1, 8, 12), bool)
    pad[:, :, 6:] = True
    want = np.asarray(jinf._yuv420_to_normalized(y, u, v, pad))
    got = tinf._yuv420_to_normalized(*(torch.from_numpy(a) for a in (y, u, v, pad)),
                                     torch.from_numpy(IMAGENET_MEAN),
                                     torch.from_numpy(IMAGENET_STD))
    assert got.shape == want.shape == (2, 1, 8, 12, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("probs_dtype", ["float32", "bfloat16", "uint8"])
def test_probability_wire_formats_match_jax(probs_dtype):
    """_finalize_masks' probabilities in each wire format, and their fetch
    back to float32 in [0, 1], against the JAX engine's (the logits are the
    engine's bf16 stride-4 ones; the resize sums run in another order, so
    float32 is held at 1e-6 and the rounded formats may differ by one step
    where a value sits on a rounding boundary)."""
    rng = np.random.RandomState(2)
    logits = (rng.randn(3, 5, 12, 16) * 3).astype(np.float32)
    stat = dict(H=48, W=64, fh=40, fw=56, oh=45, ow=61, want_probs=True, pack=False)
    jl = jnp.asarray(logits, jnp.bfloat16)
    want_wire = jinf._finalize_masks(jl, jnp.int32(2), probs_dtype=probs_dtype, **stat)
    jeng = jinf.InferenceEngine(None, None, text_encoder_type="roberta-tiny",
                                probs_dtype=probs_dtype)
    want = jeng._fetch_output(want_wire, 3, 61, True)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(torch.bfloat16)
    got_wire = tinf._finalize_masks(tl, torch.tensor(2), probs_dtype=probs_dtype, **stat)
    assert str(got_wire.dtype).endswith(probs_dtype)
    got = tinf._probs_to_host(got_wire)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (3, 45, 61)
    assert 0.0 <= got.min() and got.max() <= 1.0
    step = {"float32": 1e-6, "bfloat16": 2.0 ** -8, "uint8": 1 / 255}[probs_dtype]
    np.testing.assert_allclose(got, want, rtol=0, atol=step * 1.001)
    assert np.mean(np.abs(got - want) > 1e-6) < 0.01


@pytest.fixture(scope="module")
def model():
    return init_weights(SOC(**KW), torch.Generator().manual_seed(0)).eval()


def test_engine_yuv420_input_and_uint8_probabilities(model):
    """pixel_format='yuv420' is the planes path (the same masks as passing
    rgb_to_yuv420's planes) and stays close to the RGB path; uint8
    probabilities are the float32 ones to within half a step."""
    frames = _frames(3)
    rgb = tinf.InferenceEngine(model, device="cpu", **ENGINE)
    yuv = tinf.InferenceEngine(model, device="cpu", pixel_format="yuv420", **ENGINE)
    a = yuv.infer_video(frames, "a thing", original_size=(45, 61))
    b = rgb.infer_video(tinf.rgb_to_yuv420(frames), "a thing", original_size=(45, 61))
    np.testing.assert_array_equal(a, b)
    c = rgb.infer_video(frames, "a thing", original_size=(45, 61))
    assert a.shape == c.shape == (4, 45, 61) and (a == c).mean() > 0.95
    p32 = rgb.infer_video(frames, "a thing", return_probs=True)
    u8 = tinf.InferenceEngine(model, device="cpu", probs_dtype="uint8", **ENGINE)
    p8 = u8.infer_video(frames, "a thing", return_probs=True)
    assert p8.dtype == np.float32 and p8.shape == p32.shape == (4, 40, 56)
    np.testing.assert_allclose(p8, p32, rtol=0, atol=0.5 / 255 + 1e-6)
    with pytest.raises(ValueError, match="pixel_format"):
        tinf.InferenceEngine(model, device="cpu", pixel_format="nv12", **ENGINE)
    with pytest.raises(ValueError, match="probs_dtype"):
        tinf.InferenceEngine(model, device="cpu", probs_dtype="float16", **ENGINE)


def _infer_one(engine, item):
    """map_videos's fn in a worker process: picklable, so module-level."""
    return engine.infer_video(*item)


def _counts():
    return [getattr(fn, a) for fn, a in tinf._kernel_counters()]


def _reset_counts():
    for fn, a in tinf._kernel_counters():
        setattr(fn, a, 0)


def test_engine_pool_and_pipelined_runs(model):
    """Two CPU "devices": each engine runs in a worker process of its own on a
    copy of the model; items go round robin, and map_videos' and
    run_videos_pipelined's results are bit-equal to one engine's; the
    workers' kernel and plain-call counts are added to this process's;
    update_params reaches every worker and skips the object it loaded last;
    close() ends the workers. A pool of one device is that engine, in this
    process, on the given model."""
    videos = [_frames(4 + i, t=3) for i in range(3)]
    texts = ["a thing", "another thing", "the left one"]
    single = tinf.InferenceEngine(model, device="cpu", **ENGINE)
    _reset_counts()
    want = [single.infer_video(v, t) for v, t in zip(videos, texts)]
    want_counts = _counts()
    assert want_counts[1] > 0  # the plain MSDA ran
    one = tinf.EnginePool(model, devices=["cpu"], **ENGINE)
    assert isinstance(one.engines[0], tinf.InferenceEngine) and one.engines[0].model is model
    with tinf.EnginePool(model, devices=["cpu", "cpu"], **ENGINE) as pool:
        workers = pool.engines
        assert len(workers) == 2 and all(isinstance(w, tinf._EngineWorker) and w.proc.is_alive()
                                         for w in workers)
        _reset_counts()
        got = pool.map_videos(list(zip(videos, texts)), _infer_one)
        assert _counts() == want_counts
        items = [{"v": v, "t": t} for v, t in zip(videos, texts)]
        _reset_counts()
        piped = tinf.run_videos_pipelined(pool, items, lambda it: dict(frames=it["v"],
                                                                       texts=[it["t"]]),
                                          lambda it, res: res[0])
        assert _counts() == want_counts
        for g, p, w in zip(got, piped, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(p, w)
        # zeroed weights reach every worker: both give the zeroed model's masks
        sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
        zeroed = copy.deepcopy(model)
        zeroed.load_state_dict(sd)
        want_zero = tinf.InferenceEngine(zeroed, device="cpu", **ENGINE).infer_video(
            videos[0], texts[0])
        assert not np.array_equal(want_zero, want[0])
        sent = []
        for w in workers:
            w.send = (lambda send: lambda msg, *a: (sent.append(msg[0]), send(msg, *a)))(w.send)
        pool.update_params(sd)
        pool.update_params(sd)  # the same object: nothing is sent
        assert sent == ["params", "params"]
        for got in pool.map_videos([(videos[0], texts[0])] * 2, _infer_one):
            np.testing.assert_array_equal(got, want_zero)
    assert not any(w.proc.is_alive() for w in workers)


def test_engine_pool_worker_error_reaches_the_caller(model):
    """A worker that raises: the caller gets its exception with the worker's
    traceback, within a time limit, the pool closes and no process is left
    alive; a pool whose worker has died raises instead of waiting for it."""
    frames = _frames(7, t=2)
    pool = tinf.EnginePool(model, devices=["cpu", "cpu"], **ENGINE)
    worker = pool.engines[1]
    items = [dict(frames=frames, texts=["a thing"]),
             dict(frames=frames.astype(np.int16), texts=["a thing"])]  # item 1: worker 1's
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)worker on cpu failed.*frames must be"):
        tinf.run_videos_pipelined(pool, items, lambda it: it, lambda it, res: res)
    assert time.monotonic() - t0 < 30
    worker.proc.join(10)
    assert not worker.proc.is_alive()
    pool = tinf.EnginePool(model, devices=["cpu", "cpu"], **ENGINE)
    try:
        pool.engines[1].proc.kill()
        pool.engines[1].proc.join(10)
        with pytest.raises(RuntimeError, match="worker on cpu"):
            pool.map_videos([(frames, "a"), (frames, "b")], _infer_one)
    finally:
        pool.close()
    assert not pool.engines[1].proc.is_alive()


def test_engine_pool_defaults_to_every_card(model):
    """devices=None means every visible CUDA card; without one it raises and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.EnginePool(model, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.InferenceEngine(model, **ENGINE)


def test_shard_videos_without_a_process_group():
    items = list(range(7))
    assert tinf.shard_videos(items) == items
    assert tinf.shard_videos(items, 3, 1) == jinf.shard_videos(items, 3, 1) == [1, 4]


def test_save_helpers_write_the_jax_files(tmp_path):
    rng = np.random.RandomState(5)
    preds = [{"video_id": "vidA", "exp_id": "1", "frame_indices": ["00000", "00005"],
              "pred_masks": rng.randint(0, 2, (2, 12, 17)).astype(np.uint8)}]
    objects = [rng.rand(2, 6, 7) for _ in range(3)]
    for mod, d in ((tinf, tmp_path / "port"), (jinf, tmp_path / "jax")):
        mod.save_ytvos_predictions(preds, str(d))
        mod.zip_submission(str(d))
        index = mod.merge_davis_annotator(objects)
        mod.save_davis_annotator_masks(index, str(d / "davis"), ["a", "b"])
    for rel in ("Annotations/vidA/1/00000.png", "Annotations/vidA/1/00005.png",
                "davis/a.png", "davis/b.png"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert zipfile.ZipFile(tmp_path / "port" / "submission.zip").namelist() == \
        zipfile.ZipFile(tmp_path / "jax" / "submission.zip").namelist()
    items = list(range(8))
    assert tinf.group_davis_annotator_order(items) == jinf.group_davis_annotator_order(items)
    probs = [rng.rand(2, 5, 5) for _ in range(2)]
    np.testing.assert_array_equal(tinf.merge_davis_annotator(probs),
                                  jinf.merge_davis_annotator(probs))
    with pytest.raises(ValueError, match="4 annotation variants"):
        tinf.group_davis_annotator_order(items[:6])


def test_config_flags_equal_jax(tmp_path):
    """Each flag the port keeps sets the config key the JAX flag of its name
    sets (JAX alone also stores its running_mode default); the JAX flags no
    port code reads are refused, not silently accepted."""
    argv = ["-c", "configs/tiny_synthetic.yaml", "-b", "video-swin-b", "-ckpt", "w.pth.tar",
            "--output_dir", "out"]
    got = config_from_args(add_config_args(argparse.ArgumentParser()).parse_args(argv))
    want = jax_config_from_args(jax_add_config_args(argparse.ArgumentParser()).parse_args(argv))
    assert got.to_dict() == {k: v for k, v in want.to_dict().items() if k != "running_mode"}
    assert got.backbone == "video-swin-b" and got.checkpoint_path == "w.pth.tar"
    for extra in (["-pw", "w"], ["-bpp", "b"], ["-rm", "infer"], ["--lr", "3e-4"]):
        with pytest.raises(SystemExit):
            add_config_args(argparse.ArgumentParser()).parse_args(argv + extra)


def test_multihost_is_a_no_op_in_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(None) is False
    assert initialize_distributed({"num_processes": 1}) is False
    assert is_main_process()
    barrier("noop")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank"):
        initialize_distributed(None)
