"""The post-optimizer cell run whole at toy size on the CPU, the look for a
card skipped: a sound run comes out correct and each planted fault makes
`correct` false; a program that never re-fits its budgets stops the run
with an error; the step's counted work; the cell's readers find their files and read the traced
run's numbers."""
import time

import pytest

from gsbench import harness
from gsbench.tests.toy import VIEW_CONFIG

CELL = "postopt-uav-whu-tau6"
CONFIG = dict(VIEW_CONFIG, views=6, width=48, height=36, focal_px=32.0,
              flight=dict(cols=3, rows=2, margin=0.6, altitude=6.5, oblique_deg=30.0))
TRAFFIC = dict(warmup_iters=5, settle_iters=2, stretch_after=1, stretch_min_interp=20, profile_after=1,
               profile_iters=2, start_max_instances=65536)
METRICS = ("postopt.step_device_ms", "postopt.select_device_ms", "postopt.iter_host_ms", "postopt.step_mfu_pct",
           "interp_bwd_roofline.postopt")


def toy(seed=24680135791, trace=False, **kw):
    from gsbench import run

    traffic = dict(TRAFFIC, **kw.pop("traffic", {}))
    return run.run_cell(CELL, seed, 1.0, trace, "cpu", config=dict(CONFIG), traffic=traffic,
                        t_process=time.perf_counter(), **kw)


def test_a_sound_run_is_correct():
    ctx = toy()
    line = harness.result_line(ctx)
    assert line["correct"], line["limits"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_iter_ms", "setup_s"}
    assert list(line["limits"]) == ["cut", "terms", "grad", "change", "overflow"]


@pytest.mark.parametrize("fault", ["no_parent_grad", "altered_interp"])
def test_a_planted_fault_is_not_correct(fault):
    line = harness.result_line(toy(fault=fault))
    assert not line["correct"], line["limits"]


def test_a_program_that_does_not_refit_stops_the_run(monkeypatch):
    """The budgets kept as given, from a start budget every toy view
    overflows: the run stops where the window would open."""
    from hidegs_tpu_torch.train import budgets

    monkeypatch.setattr(budgets.BudgetRefit, "update", lambda self, raster, *a, **k: (raster, False))
    with pytest.raises(RuntimeError, match="does not re-fit"):
        toy(traffic=dict(start_max_instances=1024, warmup_iters=12))


def test_the_traced_run_reads_its_yardstick():
    """With --trace 1 on the CPU there is no profiler and no CUDA event: the
    readers that need them leave their metric out, and the check still
    counts the step's work."""
    ctx = toy(trace=True)
    assert ctx.yardstick["step_bound_ms"] > 0 and ctx.yardstick["interp_bwd_bound_ms"] > 0
    line = harness.result_line(ctx)
    assert line["correct"]
    assert set(line["metrics"]) <= set(METRICS)


def test_the_cells_readers_are_found_and_read_their_numbers():
    class Ctx:
        spans = {"step": [40.0, 42.0], "select": [1.5, 2.5]}
        yardstick = {"step_bound_ms": 4.0, "step_device_ms": 50.0, "interp_bwd_bound_ms": 1.0,
                     "interp_bwd_ms": 4.0}

    want = {"postopt.step_device_ms": 41.0, "postopt.select_device_ms": 2.0, "postopt.step_mfu_pct": 8.0,
            "interp_bwd_roofline.postopt": 25.0}
    for name, value in want.items():
        assert harness.load_reader(name)(Ctx()) == pytest.approx(value)
    bench = harness.load_benchmark()
    cell = harness.resolve_cell(bench, CELL)
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert [m["name"] for m in cell.end_to_end] == ["train_iter_ms", "setup_s"]


def test_slot_counts_leave_out_padding_culled_slots_and_unneeded_parents():
    """Six slots: two padding (their spread rows never counted), one kept
    slot with t = 1 (no parent gather), two kept ones that interpolate onto
    one parent, one culled that interpolates."""
    import torch

    from gsbench import yardstick_postopt as yp

    ri = torch.tensor([3, 4, 5, 6, 9, 9])
    pi = torch.tensor([1, 2, 2, 2, 9, 9])
    ts = torch.tensor([1.0, 0.5, 0.25, 0.5, 1.0, 1.0])
    valid = torch.tensor([True, True, True, True, False, False])
    kept = torch.tensor([True, True, True, False, True, False])
    slots = yp.slot_counts(ri, pi, ts, valid, kept)
    assert slots == {"valid": 4, "valid_interp": 3, "kept": 3, "kept_interp": 2, "child_rows": 3, "parent_rows": 1}
    row, idx = 59 * 4, 8
    assert yp.interp_fwd(4, 3)["bytes"] == 7 * (row + idx) + 4 * row
    assert yp.backward(slots)["bytes"] == (3 + 2) * (row + 2 * idx) + (3 + 1) * row


def test_step_work_grows_with_the_slots_a_step_needs():
    from gsbench import yardstick_postopt as yp

    blend = {"ops": 0, "bytes": 0}
    few = dict(valid=100, valid_interp=20, kept=50, kept_interp=10, child_rows=50, parent_rows=5)
    more = dict(few, kept=80, child_rows=80)
    a, b = (yp.step_work(1000, s, 12, 16, blend, blend) for s in (few, more))
    assert b["bytes"] > a["bytes"] and b["ops"] > a["ops"]
    assert a["bound_ms"] > 0
