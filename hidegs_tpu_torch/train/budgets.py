"""The render's budgets re-fit from its counters: the rule that the leaf
trainer (train/trainer.py) and the hierarchy post-optimizer
(train/hier_trainer.py) both run.

Port of the budget bookkeeping of hidegs_tpu/train/trainer.py. The
counters of OVERFLOW_CHECK_EVERY steps are read in one copy. A budget
whose counter overflowed in that window doubles (the visible-row budget is
capped at the row prefix); after SHRINK_WINDOW clean steps, and no sooner
than 2·SHRINK_WINDOW iterations after the last schedule event, each budget
is re-fitted to the window's peak demand (+12%, `round_budget`) when that
takes it to SHRINK_FACTOR of its size or less. A new budget is a new
RasterConfig, so a compiled step captures a graph for it and keeps the
old ones.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from hidegs_tpu_torch.raster.api import RasterConfig, round_budget

# budget counters are fetched once per this many steps: one device sync per
# window, not one per step
OVERFLOW_CHECK_EVERY = 8
# consecutive clean steps before a downward budget re-fit is considered
SHRINK_WINDOW = 200
# only shrink to at most this fraction of the current budget (hysteresis)
SHRINK_FACTOR = 0.7
# visible-row compaction pays only past this row count (the JAX package's
# crossover; not measured on the card)
COMPACTION_MIN_ROWS = 2_000_000
# the render's counters the re-fit reads, in the order of a step's row
COUNTERS = ("overflow", "block_overflow", "num_instances", "needed_blocks", "visible_overflow", "num_visible")


def fit_visible_budget(peak_visible: int, row_budget: int) -> int:
    """Visible-row compaction budget from an observed per-view peak (+25%,
    quarter-octave rounded); 0 (compaction off) when it would not beat the
    full row prefix."""
    if peak_visible <= 0 or row_budget < COMPACTION_MIN_ROWS:
        return 0
    fit = round_budget(int(peak_visible * 1.25))
    if fit >= row_budget * SHRINK_FACTOR:
        return 0
    return fit


def _with(raster: RasterConfig, **kw) -> RasterConfig:
    return dataclasses.replace(raster, **kw)


def shrink_budgets(raster: RasterConfig, win_max_inst: int, win_max_blocks: int, win_max_visible: int = 0,
                   row_budget: int = 0) -> Tuple[RasterConfig, bool]:
    """Re-fit budgets to the window's peak demand (+12% slack, the policy
    of the initial fit). Returns (raster, shrunk?)."""
    shrunk = False
    if win_max_visible > 0 and raster.max_visible:
        fit_v = fit_visible_budget(win_max_visible, row_budget or (1 << 62))
        if fit_v and fit_v <= raster.max_visible * SHRINK_FACTOR:
            print(f"  shrinking max_visible {raster.max_visible} → {fit_v} "
                  f"(peak visible {win_max_visible})", flush=True)
            raster, shrunk = _with(raster, max_visible=fit_v), True
    if win_max_inst > 0:
        fit = round_budget(int(win_max_inst * 1.12))
        if fit <= raster.max_instances * SHRINK_FACTOR:
            print(f"  budgets idle for {SHRINK_WINDOW} steps — shrinking max_instances "
                  f"{raster.max_instances} → {fit} (peak demand {win_max_inst})", flush=True)
            raster, shrunk = _with(raster, max_instances=fit), True
    if win_max_blocks > 0 and raster.max_blocks:
        fit_b = -(-int(win_max_blocks * 1.12) // 256) * 256
        if fit_b <= raster.max_blocks * SHRINK_FACTOR:
            print(f"  shrinking max_blocks {raster.max_blocks} → {fit_b} "
                  f"(peak demand {win_max_blocks})", flush=True)
            raster, shrunk = _with(raster, max_blocks=fit_b), True
    return raster, shrunk


class BudgetRefit:
    """The re-fit's bookkeeping between reads: the clean steps and the peak
    demands since the last change, and the instances and blocks dropped
    before a grow caught up. `visible_compaction` turns compaction on at
    the first visible-row demand seen, when it pays."""

    def __init__(self, visible_compaction: bool = False):
        self.visible_compaction = visible_compaction
        self.dropped_instances = self.dropped_blocks = 0
        self._reset()

    def _reset(self) -> None:
        self.clean_steps = self.win_max_inst = self.win_max_blocks = self.win_max_visible = 0

    def update(self, raster: RasterConfig, vals: Sequence[Sequence[int]], it: int, row_budget: int,
               last_event: int = 0) -> Tuple[RasterConfig, bool]:
        """The budgets after a window of steps' counters `vals` (one row of
        ints in COUNTERS order a step), read at iteration `it`; `last_event`
        is the last densify or opacity-reset iteration. Returns (raster,
        changed?)."""
        ov = sum(v[0] for v in vals)
        bov = sum(v[1] for v in vals)
        v_ov = sum(v[4] for v in vals)
        v_peak = max([0] + [v[5] for v in vals])
        changed = False
        if v_ov > 0:
            # visible-row compaction overflow drops rows from the render:
            # grow now (2x, capped at the row prefix)
            new_vb = min(raster.max_visible * 2, row_budget)
            print(f"  visible budget overflow ({v_ov} rows) — growing max_visible "
                  f"{raster.max_visible} → {new_vb}", flush=True)
            raster, changed = _with(raster, max_visible=new_vb), True
        elif raster.max_visible == 0 and v_peak > 0 and self.visible_compaction:
            # first demand observation: enable compaction if it pays
            fit = fit_visible_budget(v_peak, row_budget)
            if fit:
                print(f"  enabling visible-row compaction: max_visible={fit} "
                      f"(peak visible {v_peak} of {row_budget} rows)", flush=True)
                raster, changed = _with(raster, max_visible=fit), True
        if ov > 0:
            self.dropped_instances += ov
            new_budget = raster.max_instances * 2
            print(f"  instance budget overflow ({ov} dropped) — growing max_instances "
                  f"{raster.max_instances} → {new_budget}", flush=True)
            raster, changed = _with(raster, max_instances=new_budget), True
        if bov > 0 and raster.max_blocks:
            self.dropped_blocks += bov
            new_blocks = raster.max_blocks * 2
            print(f"  block budget overflow ({bov} blocks) — growing max_blocks "
                  f"{raster.max_blocks} → {new_blocks}", flush=True)
            raster, changed = _with(raster, max_blocks=new_blocks), True
        if changed:
            self._reset()
            return raster, True
        self.clean_steps += len(vals)
        self.win_max_inst = max([self.win_max_inst] + [v[2] for v in vals])
        self.win_max_blocks = max([self.win_max_blocks] + [v[3] for v in vals])
        self.win_max_visible = max([self.win_max_visible] + [v[5] for v in vals])
        # no shrinking near schedule events: new splats are still growing
        # into their footprint, and a shrink there is soon followed by an
        # overflow re-grow
        settled = (it - last_event) >= 2 * SHRINK_WINDOW
        if self.clean_steps >= SHRINK_WINDOW and settled:
            raster, shrunk = shrink_budgets(raster, self.win_max_inst, self.win_max_blocks,
                                            win_max_visible=self.win_max_visible, row_budget=row_budget)
            self._reset()
            return raster, shrunk
        return raster, False
