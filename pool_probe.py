"""Measurements behind EnginePool's design, on the CUDA card(s):

    python3 pool_probe.py timeslice     # kernels/s of 1, 2, 4 processes sharing card 0
    python3 pool_probe.py independent   # 1, 2, 4 engine processes on card 0 against the pool
    python3 pool_probe.py feed          # the pool over every card: the caller's time

`timeslice`: each process launches small elementwise kernels (launch-bound, like the head's) or
4096 x 4096 bf16 matmuls (device-bound); the aggregate rate against one process.
`independent`: N processes, each with its own InferenceEngine on card 0 and its own clips (no
queue), against EnginePool([card 0] * N) on as many clips: aggregate frames/s.
`feed`: one engine alone, then EnginePool over every visible card through run_videos_pipelined
(the caller's time in the workers' send and recv) and through map_videos (each clip's time
inside its worker). Video-Swin-B, bf16, K3, seeded random weights, 16 x 360 x 640 uint8 clips.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import neurips2023_soc_torch.inference as inf
from neurips2023_soc_torch.config import load_config
from neurips2023_soc_torch.models import build_model
from neurips2023_soc_torch.ops import _build

KW = dict(text_encoder_type="roberta-base", text_bucket=32, size_buckets=((360, 640),))
CLIPS = 8  # per engine in `independent`
VIDEOS = 32  # in `feed`


def model():
    cfg = load_config("configs/refer_youtube_vos.yaml", overrides={
        "backbone": "video-swin-b", "compute_dtype": "bfloat16", "swin_attn_impl": "pallas"})
    return build_model(cfg, device="cuda", seed=0)


def videos(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    return [dict(frames=rng.randint(0, 256, (16, 360, 640, 3)).astype(np.uint8), texts=["a dog"])
            for _ in range(n)]


def spawned(ctx, target, args_of, n: int, warm_s: float) -> tuple:
    """n processes of target(*args_of(rank), start, out), released together once warm;
    returns (wall seconds from the release, each process's own seconds)."""
    start, out = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args_of(r), start, out)) for r in range(n)]
    for p in procs:
        p.start()
    time.sleep(warm_s)
    t0 = time.perf_counter()
    start.set()
    times = [out.get() for _ in procs]
    wall = time.perf_counter() - t0
    for p in procs:
        p.join()
    return wall, times


def kernels(kind: str, n: int, start, out) -> None:
    torch.cuda.set_device(0)
    if kind == "small":
        x = torch.zeros(1 << 16, device="cuda")
        step = lambda: x.add_(1.0)  # noqa: E731
    else:
        a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
        step = lambda: a @ a  # noqa: E731
    for _ in range(50):
        step()
    torch.cuda.synchronize()
    start.wait()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    out.put(time.perf_counter() - t0)


def timeslice() -> None:
    ctx = mp.get_context("spawn")
    for kind, n in (("small", 20000), ("large", 400)):
        base = None
        for procs in (1, 2, 4):
            wall, times = spawned(ctx, kernels, lambda r: (kind, n), procs, 15)
            rate = procs * n / wall
            base = base or rate
            print(f"{kind}: {procs} process(es) x {n} kernels in {wall:.3f} s = {rate:.0f} "
                  f"kernels/s ({rate / base:.2f}x one process); per process "
                  f"{[round(t, 3) for t in times]}", flush=True)


def run(engine, items) -> None:
    for _ in engine.infer_videos(iter(items), depth=1):
        pass


def engine_process(rank: int, start, out) -> None:
    eng = inf.InferenceEngine(model(), **KW)
    items = videos(rank, CLIPS)
    run(eng, items[:2])
    torch.cuda.synchronize()
    start.wait()
    t0 = time.perf_counter()
    run(eng, items)
    torch.cuda.synchronize()
    out.put(time.perf_counter() - t0)


def independent() -> None:
    ctx = mp.get_context("spawn")
    _build.build_all()
    for n in (1, 2, 4):
        wall, times = spawned(ctx, engine_process, lambda r: (r,), n, 40)
        print(f"independent x{n}: {n * CLIPS} clips in {wall:.3f} s = "
              f"{n * CLIPS * 16 / wall:.2f} frames/s; per process {[round(t, 3) for t in times]}",
              flush=True)
    m = model()
    for n in (2, 4):
        with inf.EnginePool(m, devices=[torch.device("cuda", 0)] * n, **KW) as pool:
            items = videos(100, n * CLIPS)
            inf.run_videos_pipelined(pool, items[:2 * n], lambda it: it, lambda it, r: None)
            t0 = time.perf_counter()
            inf.run_videos_pipelined(pool, items, lambda it: it, lambda it, r: None)
            wall = time.perf_counter() - t0
        print(f"EnginePool x{n}: {n * CLIPS} clips in {wall:.3f} s = "
              f"{n * CLIPS * 16 / wall:.2f} frames/s", flush=True)


def timed_infer(engine, item):
    """map_videos's fn: the clip's masks and its milliseconds inside the worker."""
    t0 = time.perf_counter()
    res = engine.infer_video_multi(**item)
    return res[0], (time.perf_counter() - t0) * 1e3


def feed() -> None:
    m = model()
    items = videos(0, VIDEOS)
    ident = lambda it: it  # noqa: E731
    one = inf.InferenceEngine(m, **KW)
    inf.run_videos_pipelined(one, items[:4], ident, lambda it, r: None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inf.run_videos_pipelined(one, items, ident, lambda it, r: None)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    print(f"one engine: {VIDEOS} clips in {one_s:.3f} s = {VIDEOS * 16 / one_s:.2f} frames/s",
          flush=True)
    spent = {"send": 0.0, "recv": 0.0}

    def timing(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapped

    inf._EngineWorker.send = timing("send", inf._EngineWorker.send)
    inf._EngineWorker.recv = timing("recv", inf._EngineWorker.recv)
    with inf.EnginePool(m, **KW) as pool:
        n = len(pool.engines)
        inf.run_videos_pipelined(pool, items[:2 * n], ident, lambda it, r: None)
        spent.update(send=0.0, recv=0.0)
        t0 = time.perf_counter()
        inf.run_videos_pipelined(pool, items, ident, lambda it, r: None)
        wall = time.perf_counter() - t0
        print(f"pool x{n} run_videos_pipelined: {VIDEOS} clips in {wall:.3f} s = "
              f"{VIDEOS * 16 / wall:.2f} frames/s ({one_s / wall:.2f}x); caller ms: "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in spent.items()), flush=True)
        spent.update(send=0.0, recv=0.0)
        t0 = time.perf_counter()
        ms = [t for _, t in pool.map_videos(items, timed_infer)]
        wall = time.perf_counter() - t0
        print(f"pool x{n} map_videos: {VIDEOS} clips in {wall:.3f} s = "
              f"{VIDEOS * 16 / wall:.2f} frames/s; in-worker ms per clip median "
              f"{np.median(ms):.1f} (min {min(ms):.1f}, max {max(ms):.1f}); caller ms: "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in spent.items()), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("pool_probe.py: CUDA is not available")
    commands = {"timeslice": timeslice, "independent": independent, "feed": feed}
    if sys.argv[1:] not in ([c] for c in commands):
        sys.exit(f"usage: python3 pool_probe.py {{{','.join(commands)}}}")
    commands[sys.argv[1]]()
