"""The check fails what it has to fail, at the tiny configuration on the
CPU: a run driven as on the card (the card check skipped) with the timed path
broken underneath reads `correct` false, once for each fault a cell can
have (a mask altered where the engine makes it; the trajectory choice
broken, so the masks are those of another query); and the control, the
reference computed in float8, fails the limits the program meets. The
fixture cell's limits sit far above the program's CPU readings (it computes
in float32 there: mask mismatches 0.002 of bfloat16's, the float32 best
query chosen) and far below these."""
import pytest

from benchmark import correct
from benchmark.run import run_cell
from benchmark.spec import load_cell

from .fixture_root import ENGINE, make_root

SEED = 2 ** 31 + 211


def run(tmp_path, cell):
    return run_cell(cell, SEED, 1.0, False, "cpu", root=make_root(tmp_path))


def test_engine_answer_altered_where_produced(tmp_path, monkeypatch):
    from neurips2023_soc_torch import inference

    finalize = inference._finalize_masks

    def altered(*a, **k):
        out = finalize(*a, **k).clone()
        out[0] = 255 - out[0]
        return out

    monkeypatch.setattr(inference, "_finalize_masks", altered)
    assert run(tmp_path, ENGINE)["correct"] is False


@pytest.mark.parametrize("fault", ["fault_query0", "fault_lowest"])
def test_engine_trajectory_choice_broken(tmp_path, fault):
    from benchmark.calibrate import planted

    with planted(fault):
        line = run(tmp_path, ENGINE)
    assert line["correct"] is False
    assert line["checks"]["query_gap_vs_bf16"]["value"] > line["checks"]["query_gap_vs_bf16"][
        "limit"]


def test_engine_control_fails_the_limits(tmp_path):
    from benchmark.calibrate import engine_readings

    make_root(tmp_path)
    cell = load_cell(ENGINE, tmp_path)
    readings = list(engine_readings(cell, [], [SEED], "cpu"))
    got = readings[0]
    assert got["side"] == "control"
    assert not correct.passed(correct.verdict(got, cell["limits"]))
