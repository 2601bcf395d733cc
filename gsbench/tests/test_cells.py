"""Each cell run whole at toy sizes, the look for a card skipped: sound runs
come out correct, and each fault a cell can have, planted under the timed
path, makes `correct` false. Tests marked `cuda` run the control (the
program's bf16 attribute stream) on a card at a small size, where it has
to come out not correct, and a sound run beside it."""
import pytest
import torch

from gsbench import harness
from gsbench.tests.toy import PARKED, TRAIN_CONFIG, TRAIN_TRAFFIC, VIEW_CONFIG, VIEW_TRAFFIC, parked_pkg, run_toy

LOD_TRAFFIC = dict(VIEW_TRAFFIC, path=dict(kind="fly_through", poses=40, period=20, margin=0.75, altitude=6.5,
                                           pitch_lo=30.0, pitch_hi=45.0), warmup_stride=5)
CELLS = ("train-uav-whu", "view-uav-whu", "lod-uav-whu-tau6", "lod-uav-whu-tau15")


def toy(cell, root=None, **kw):
    """`cell` at toy size on the CPU; a parked cell runs from `root`."""
    from gsbench import run

    if cell in PARKED:
        kw["pkg"] = parked_pkg(root, cell)

    if cell.startswith("lod"):
        return run.run_cell(cell, kw.pop("seed", 24680135790), 1.0, False, kw.pop("device", "cpu"),
                            config=dict(VIEW_CONFIG), traffic=dict(LOD_TRAFFIC), t_process=0.0, **kw)
    return run_toy(cell, **kw)


def result(ctx):
    return harness.result_line(ctx)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tmp_path):
    ctx = toy(cell, tmp_path)
    line = result(ctx)
    assert line["correct"], line["limits"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in ctx.cell.end_to_end}
    assert set(line["metrics"]) == names
    assert list(line)[-1] == "limits"


@pytest.mark.parametrize("cell,fault", [("train-uav-whu", "unchanged"), ("train-uav-whu", "half_batch"),
                                        ("train-uav-whu", "altered"), ("train-uav-whu", "altered_round"),
                                        ("view-uav-whu", "altered"),
                                        ("lod-uav-whu-tau6", "altered"), ("lod-uav-whu-tau15", "altered")])
def test_a_planted_fault_is_not_correct(cell, fault, tmp_path):
    assert not result(toy(cell, tmp_path, fault=fault))["correct"]


SMALL = {
    "train-uav-whu": (dict(TRAIN_CONFIG, n_ground=60000, width=320, height=240, focal_px=213.3),
                      dict(TRAIN_TRAFFIC, warmup_iters=5)),
    "lod-uav-whu-tau6": (dict(VIEW_CONFIG, n_ground=100000), dict(LOD_TRAFFIC, width=480, height=270, focal_px=320.0)),
    "lod-uav-whu-tau15": (dict(VIEW_CONFIG, n_ground=100000),
                          dict(LOD_TRAFFIC, width=480, height=270, focal_px=320.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_on_the_card_the_control_is_not_correct_and_the_program_is(card, cell):
    from gsbench import run

    config, traffic = SMALL[cell]
    for seed in (1234567891, 2876543211, 31337):
        ctl = run.run_cell(cell, seed, 2.0, False, card, config=dict(config), traffic=dict(traffic), control=True)
        assert not result(ctl)["correct"], (seed, result(ctl)["limits"])
        ok = run.run_cell(cell, seed, 2.0, False, card, config=dict(config), traffic=dict(traffic))
        assert result(ok)["correct"], (seed, result(ok)["limits"])
        del ctl, ok
        torch.cuda.empty_cache()
