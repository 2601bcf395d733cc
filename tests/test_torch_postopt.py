"""The hierarchy post-optimizer as the benchmark runs it, on the CPU.

  * the port's eager post-opt step (train/hier_trainer.py: `select_cut`,
    `hier_train_step`) against the benchmark's frozen plain reference
    (gsbench/reference/train/hier_trainer.py) on a seeded toy hierarchy
    (the UAV generator at toy size, the frozen native builder), three
    chained steps with the exposure trained: the cut exactly, the loss and
    each leaf's gradient norm over the children and over the parents at
    1e-5 relative;
  * the budget re-fit of `post_optimize` (train/budgets.py): a run that
    starts from an instance budget the views overflow grows it at a read
    of the counters, and from then on each step is bitwise the step at the
    grown budget from the same state, which a run started there takes from
    its first step;
  * the leaf trainer's re-fit after the move to train/budgets.py, bit for
    bit the rule it had inline (a frozen copy below), on windows of
    counters drawn from a seed;
  * the post-optimizer's spans and their attributes under
    `profiling.enable()`.
"""
import dataclasses
import random

import pytest
import torch

from gsbench.checks.common import ref_camera
from gsbench.drivers.postopt import grad_norms, row_masks
from gsbench.scenes import flight, hierarchy, uav
from hidegs_tpu_torch.core.camera_math import make_camera
from hidegs_tpu_torch.hier.io import Hierarchy
from hidegs_tpu_torch.hier.lod import tau_to_target_size
from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
from hidegs_tpu_torch.raster.api import RasterConfig, round_budget
from hidegs_tpu_torch.train import budgets
from hidegs_tpu_torch.train import hier_trainer as ht
from hidegs_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, W, FOCAL = 48, 64, 42.0
BUDGET = 4096
RCFG = RasterConfig(backend="blend", max_instances=1 << 16)


@pytest.fixture(scope="module")
def toy():
    """(hierarchy fields, four poses, their targets, the cut's target size)."""
    means, scales, quats, opac, shs = (a.numpy() for a in uav.make_uav_gaussians(
        7, "cpu", n_ground=1500, n_structs=3, per_struct=30))
    fields = hierarchy.build_hierarchy(means, quats, scales, opac, shs)
    poses = flight.orbit(4, 9.0, 6.5, 30.0, 45.0, W, H, FOCAL)
    g = torch.Generator().manual_seed(11)
    targets = [torch.rand((3, H, W), generator=g) for _ in poses]
    return fields, poses, targets, tau_to_target_size(2.0, FOCAL)


def program_camera(p):
    return make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width, device="cpu")


def rel(a, b):
    return float(abs(a - b) / max(abs(b), 1e-30))


def test_eager_steps_match_the_frozen_reference(toy):
    from gsbench.checks import postopt as check
    from gsbench.reference.model.schedules import LRConfig as RefLR
    from gsbench.reference.model.schedules import lr_tree as ref_lr_tree
    from gsbench.reference.raster.api import RasterConfig as RefConfig
    from gsbench.reference.train import hier_trainer as ref

    fields, poses, targets, target = toy
    ts = ht.state_from_hierarchy(Hierarchy(**fields), num_images=len(poses), device="cpu")
    rts = check.reference_state(fields, ts, "cpu")
    P = int(ts.params.xyz.shape[0])
    rcfg = RefConfig(backend="blend", tile=RCFG.tile, max_instances=RCFG.max_instances)
    for k, view in enumerate((0, 2, 1)):
        cut = ht.select_cut(ts, program_camera(poses[view]), target, BUDGET)
        rcut = ref.select_cut(rts, ref_camera(poses[view], "cpu"), target, BUDGET)
        for f in cut._fields:
            assert torch.equal(getattr(cut, f), getattr(rcut, f)), (k, f)
        assert bool(((cut.ts > 0) & (cut.ts < 1) & cut.valid).any())
        new, m = ht.hier_train_step(ts, cut, program_camera(poses[view]), targets[view],
                                    lr_tree(ts.step, LRConfig(), 1.0), RCFG, image_idx=view, use_exposure=True,
                                    optimize_exposure=True)
        rnew, rm = ref.hier_train_step(rts, rcut, ref_camera(poses[view], "cpu"), targets[view],
                                       ref_lr_tree(rts.step, RefLR(), 1.0), rcfg, image_idx=view, use_exposure=True,
                                       optimize_exposure=True)
        assert int(m["counters"][0]) == int(rm["overflow"]) == 0
        assert rel(float(m["loss"]), float(rm["loss"])) <= 1e-5, k
        g, rg = (grad_norms(a.opt, b.opt, row_masks(cut, P)).tolist() for a, b in ((ts, new), (rts, rnew)))
        assert min(rg) > 0, rg  # every leaf has a gradient on children and on parents
        for n, (a, b) in enumerate(zip(g, rg)):
            assert rel(a, b) <= 1e-5, (k, n, a, b)
        assert int(m["n_visible"]) == int(rm["n_visible"])
        ts, rts = new, rnew
    for a, b in zip(ts.params, rts.params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(ts.exposure, rts.exposure, rtol=1e-5, atol=1e-7)


def _post_optimize(toy, monkeypatch, max_instances, iterations=24, hold=None):
    """post_optimize on the toy from `max_instances`; each step's budget,
    counters and (with `hold`) a check of the step against its input."""
    fields, poses, targets, target = toy
    steps = []
    step = ht.hier_train_step

    def recorded(ts, cut, cam, gt, lrs, rcfg, **kw):
        out = step(ts, cut, cam, gt, lrs, rcfg, **kw)
        if hold is not None:
            hold(ts, cut, cam, gt, lrs, rcfg, kw, out)
        steps.append((rcfg.max_instances, out[1]["counters"].tolist(), float(out[1]["loss"])))
        return out

    monkeypatch.setattr(ht, "hier_train_step", recorded)
    ts = ht.post_optimize(Hierarchy(**fields), [program_camera(p) for p in poses], targets, iterations=iterations,
                          target_size=target, budget=BUDGET,
                          raster_cfg=dataclasses.replace(RCFG, max_instances=max_instances), log_every=1000,
                          optimize_exposure=True, device="cpu")
    return ts, steps


def test_an_overflowing_run_grows_its_budget_then_matches_a_run_started_there(toy, monkeypatch, capsys):
    step = ht.hier_train_step
    _, probe = _post_optimize(toy, monkeypatch, 1 << 16, iterations=16)
    need = max(c[2] for _, c, _ in probe)
    assert all(c[0] == 0 for _, c, _ in probe)
    start = round_budget(need) // 4
    same = []

    def hold(ts, cut, cam, gt, lrs, rcfg, kw, out):
        # the same step at a budget that holds every view
        big, bm = step(ts, cut, cam, gt, lrs, dataclasses.replace(rcfg, max_instances=1 << 16), **kw)
        same.append(torch.equal(bm["loss"], out[1]["loss"])
                    and all(torch.equal(a, b) for a, b in zip(big.params, out[0].params)))

    _, steps = _post_optimize(toy, monkeypatch, start, hold=hold)
    out = capsys.readouterr().out
    assert f"growing max_instances {start} → {2 * start}" in out and "instances were dropped" in out
    every = budgets.OVERFLOW_CHECK_EVERY
    assert all(b == start for b, _, _ in steps[:every]) and any(c[0] > 0 for _, c, _ in steps[:every])
    for k in range(1, len(steps)):  # the budget changes only at a read
        assert steps[k][0] == steps[k - 1][0] or k % every == 0, k
    last = steps[-1][0]
    grown = [k for k, (b, _, _) in enumerate(steps) if b == last]
    assert last >= need and len(grown) >= every
    for k in grown:  # no overflow, and bitwise the step at the large budget
        assert steps[k][1][0] == 0 and same[k], k
    assert not all(same)  # the overflowing steps were not
    # a run started at the grown budget reads no overflow and grows nothing
    _, fresh = _post_optimize(toy, monkeypatch, last)
    assert all(b == last and c[0] == 0 for b, c, _ in fresh)
    assert "growing" not in capsys.readouterr().out


def _inline_rule(cfg_raster, state, vals, it, row_budget, last_schedule_event, visible_compaction):
    """A frozen copy of the leaf trainer's inline re-fit before it moved to
    train/budgets.py (train/trainer.py at its parent commit; the shrink
    through trainer._maybe_shrink_budgets, which printed what
    budgets.shrink_budgets prints). Returns (raster, changed)."""
    r = cfg_raster
    ov = sum(v[0] for v in vals)
    bov = sum(v[1] for v in vals)
    v_ov = sum(v[4] for v in vals)
    v_peak = max([0] + [v[5] for v in vals])
    changed = False
    if v_ov > 0:
        new_vb = min(r.max_visible * 2, row_budget)
        print(f"  visible budget overflow ({v_ov} rows) — growing max_visible {r.max_visible} → {new_vb}",
              flush=True)
        r = dataclasses.replace(r, max_visible=new_vb)
        changed = True
    elif r.max_visible == 0 and v_peak > 0 and visible_compaction:
        fit = budgets.fit_visible_budget(v_peak, row_budget)
        if fit:
            print(f"  enabling visible-row compaction: max_visible={fit} (peak visible {v_peak} of {row_budget} rows)",
                  flush=True)
            r = dataclasses.replace(r, max_visible=fit)
            changed = True
    if ov > 0:
        state["dropped"] += ov
        print(f"  instance budget overflow ({ov} dropped) — growing max_instances {r.max_instances} → "
              f"{r.max_instances * 2}", flush=True)
        r = dataclasses.replace(r, max_instances=r.max_instances * 2)
        changed = True
    if bov > 0 and r.max_blocks:
        state["dropped_blocks"] += bov
        print(f"  block budget overflow ({bov} blocks) — growing max_blocks {r.max_blocks} → {r.max_blocks * 2}",
              flush=True)
        r = dataclasses.replace(r, max_blocks=r.max_blocks * 2)
        changed = True
    if changed:
        state.update(clean=0, inst=0, blocks=0, visible=0)
        return r, True
    state["clean"] += len(vals)
    state["inst"] = max([state["inst"]] + [v[2] for v in vals])
    state["blocks"] = max([state["blocks"]] + [v[3] for v in vals])
    state["visible"] = max([state["visible"]] + [v[5] for v in vals])
    settled = (it - last_schedule_event) >= 2 * budgets.SHRINK_WINDOW
    shrunk = False
    if state["clean"] >= budgets.SHRINK_WINDOW and settled:
        r, shrunk = budgets.shrink_budgets(r, state["inst"], state["blocks"], win_max_visible=state["visible"],
                                           row_budget=row_budget)
        state.update(clean=0, inst=0, blocks=0, visible=0)
    return r, shrunk


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_trainers_refit_is_its_inline_rule_bit_for_bit(seed, capsys):
    """Windows of counters drawn from `seed` (overflows now and then, peaks
    that shrink, visible rows, blocks), a schedule event now and then:
    the shared rule's budgets, `changed`, prints and dropped counts are the
    old inline rule's after every read."""
    rng = random.Random(seed)
    r0 = RasterConfig(max_instances=1 << 16, max_blocks=rng.choice([0, 4096]),
                      max_visible=rng.choice([0, 1 << 20]))
    refit, state = budgets.BudgetRefit(visible_compaction=bool(seed % 2)), dict(clean=0, inst=0, blocks=0,
                                                                                  visible=0, dropped=0,
                                                                                  dropped_blocks=0)
    a = b = r0
    last_event, row_budget = 0, 1 << 22
    for it in range(9, 6000, 8):
        if rng.random() < 0.01:
            last_event = it
        vals = [(int(rng.random() < 0.02) * rng.randrange(1, 5000), int(rng.random() < 0.02) * rng.randrange(1, 9),
                 rng.randrange(1, a.max_instances), rng.randrange(1, 5000), int(rng.random() < 0.01) * 7,
                 rng.randrange(1, 3_000_000)) for _ in range(8)]
        a, changed_a = refit.update(a, vals, it, row_budget, last_event=last_event)
        out_a = capsys.readouterr().out
        b, changed_b = _inline_rule(b, state, vals, it, row_budget, last_event, bool(seed % 2))
        out_b = capsys.readouterr().out
        assert (a, changed_a, out_a) == (b, changed_b, out_b), it
        assert (refit.dropped_instances, refit.dropped_blocks) == (state["dropped"], state["dropped_blocks"])
    assert a != r0


def test_post_optimize_records_its_spans(toy):
    """Under `profiling.enable()`: one `postopt.iteration` root per
    iteration, its request the iteration; inside it `postopt.select`
    (budget), `postopt.step` (image size, budgets in force), the budget
    read every 8 iterations and the log's read as wait spans."""
    fields, poses, targets, target = toy
    profiling.clear()
    profiling.enable()
    try:
        ht.post_optimize(Hierarchy(**fields), [program_camera(p) for p in poses], targets, iterations=10,
                         target_size=target, budget=BUDGET, raster_cfg=RCFG, log_every=5, optimize_exposure=True,
                         device="cpu")
    finally:
        profiling.disable()
    recs = profiling.records()
    profiling.clear()
    roots = [r for r in recs if r.name == "postopt.iteration"]
    assert [r.request for r in roots] == list(range(1, 11)) and all(r.parent is None for r in roots)
    by_root = {r.id: [c for c in recs if c.parent == r.id] for r in roots}
    for r in roots:
        names = [c.name for c in sorted(by_root[r.id], key=lambda c: c.start_ns)]
        want = (["postopt.read_budgets"] if r.request == 9 else []) + ["postopt.select", "postopt.step"] + (
            ["postopt.read_log"] if r.request % 5 == 0 else [])
        assert names == want, (r.request, names)
        for c in by_root[r.id]:
            assert c.request == r.request and c.wait == c.name.startswith("postopt.read")
            if c.name == "postopt.select":
                assert c.attrs == {"budget": BUDGET}
            if c.name == "postopt.step":
                assert c.attrs == {"image": (H, W), "max_instances": RCFG.max_instances, "max_blocks": 0,
                                   "max_visible": 0}
            if c.name == "postopt.read_budgets":
                assert c.attrs == {"refit": 0}
