"""The readings the check's limits are set from, in one process on the card:
the program's compared numbers on many seeds (the lower readings) and the
control's on a few (the upper readings). The control is the reference in
the next precision below the configuration's bfloat16: every bfloat16 tensor
it makes rounded through float8 (e4m3, one scale per tensor).

    python3 -m benchmark.calibrate --workload <cell> --seeds <n>... --control-seeds <n>...
        [--sides program control fault_query0 fault_lowest ...]

Per seed the sampled videos of a run (the longest, the one with the most
expressions and two drawn from the seed) go through
InferenceEngine.infer_videos at the cell's size; the control's masks come
from the reference's own outputs. The planted faults run the program with
its trajectory choice broken: query 0 for every video (`fault_query0`), or
the lowest-scoring query (`fault_lowest`). Prints one JSON line per reading,
with each expression's choice (see correct.engine_gaps).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager, nullcontext

import torch

from . import correct
from .reference import build_reference, plain_float32
from .run import cache_dirs
from .spec import ROOT, load_cell
from .weights import make_weights

# torch's own TF32 settings, as a run leaves them for the program
DEFAULT_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def program_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = DEFAULT_TF32


def witness_cell(cell):
    """The cell with the program in float32: another path of the program."""
    return dict(cell, config_data=dict(cell["config_data"], compute_dtype="float32"))


@contextmanager
def planted(fault: str):
    """The program's trajectory choice broken as `fault` says."""
    from neurips2023_soc_torch import inference

    original = inference._select_in_graph

    def broken(score_sums, trajectory):
        total = torch.stack(score_sums).sum(0)
        q = torch.zeros_like(torch.argmax(total)) if fault == "fault_query0" \
            else torch.argmin(total)
        return [q] * len(score_sums)

    inference._select_in_graph = broken
    try:
        yield
    finally:
        inference._select_in_graph = original


FAULTS = ("fault_query0", "fault_lowest")


def engine_readings(cell, seeds, control_seeds, device, sides=("program",)):
    """Per seed, each side's compared numbers against the float32 reference:
    the program (the cell's configuration), the reference in bfloat16 and the
    control; the control also on every seed of `control_seeds`."""
    from neurips2023_soc_torch.inference import InferenceEngine

    from .drivers import engine as drv
    from .spec import generator

    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        want = [x for x in sides if seed in seeds] + (["control"] if seed in control_seeds
                                                      and "control" not in sides else [])
        cfg, mix = cell["config_data"], cell["traffic_data"]
        st = drv.State()
        st.cell, st.seed, st.device, st.cfg, st.mix = cell, seed, device, cfg, mix
        st.videos = generator(mix["generator"]).make(mix, seed, device)
        st.sample = st.videos.sample(seed, mix["check_videos"])
        uses = {i: 10 ** 6 + i for i in st.sample}
        st.results = {i: (uses[i], None) for i in st.sample}
        weights = make_weights(cfg, seed, device)
        refs, bf16 = drv.reference_sides(st, weights)
        for side in want:
            t0 = time.time()
            if side == "program" or side in FAULTS:
                program_precision()
                model = drv.build_program(cfg, seed, device)
                engine = InferenceEngine(
                    model, text_encoder_type=cfg["text_encoder_type"],
                    text_bucket=cfg["text_bucket"], time_buckets=mix["time_buckets"],
                    size_buckets=[tuple(mix["frame_size"])], device=device)
                items = [st.videos.item(i, uses[i]) for i in st.sample]
                with planted(side) if side in FAULTS else nullcontext():
                    got = dict(zip(st.sample, engine.infer_videos(iter(items), depth=1)))
                del engine, model
                plain_float32()
            elif side == "reference_bf16":
                got = {i: drv.control_masks(bf16[i], st.videos.pool[i].frames.shape[0])
                       for i in st.sample}
            else:
                low = build_reference(cfg, torch.bfloat16, device, fp8=side == "control")
                low.load_state_dict(weights, strict=True)
                lows = drv.reference_results(st, low.eval(), st.sample)
                got = {i: drv.control_masks(lows[i], st.videos.pool[i].frames.shape[0])
                       for i in st.sample}
                del low, lows
            torch.cuda.empty_cache()
            choices = []
            numbers = correct.engine_numbers(got, refs, bf16, drv.lengths(st), choices)
            yield {"side": side, "seed": seed, "seconds": time.time() - t0, **numbers,
                   "choices": choices}
        del refs, bf16, weights
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--sides", nargs="+", default=["program"],
                   help="program, reference_bf16, control, and the planted faults "
                        + ", ".join(FAULTS))
    p.add_argument("--witness", action="store_true",
                   help="run the program in float32 (a second witness) instead")
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    cell = load_cell(args.workload)
    if args.witness:
        cell = witness_cell(cell)
    for r in engine_readings(cell, args.seeds, args.control_seeds, args.device,
                             sides=tuple(args.sides)):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
