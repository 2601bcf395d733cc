"""The yardstick at toy sizes on the CPU: generators deterministic by seed,
the frozen count functions against hand counts."""
import numpy as np
import pytest
import torch

from gsbench import yardstick as ys
from gsbench.scenes import flight, training, uav

from gsbench.tests.toy import TRAIN_CONFIG


def test_served_model_is_deterministic_by_seed():
    a = uav.make_uav_gaussians(5, "cpu", n_ground=500, n_structs=2, per_struct=10)
    b = uav.make_uav_gaussians(5, "cpu", n_ground=500, n_structs=2, per_struct=10)
    c = uav.make_uav_gaussians(6, "cpu", n_ground=500, n_structs=2, per_struct=10)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert x.shape == z.shape
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (520, 3) and a[4].shape == (520, 16, 3)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3_000_000_019])
def test_training_scene_is_deterministic_by_seed_and_sized_alike(seed):
    from gsbench import harness

    cfg = harness.load_json(harness.PKG / "configs" / "uav-whu-1m.json")
    cfg.update(TRAIN_CONFIG)
    a, b = training.build(cfg, seed, "cpu"), training.build(cfg, seed, "cpu")
    assert np.array_equal(a.info.points, b.info.points) and np.array_equal(a.info.colors, b.info.colors)
    assert len(a.train_cameras) == cfg["views"] == 6
    for va, vb in zip(a.train_cameras.views, b.train_cameras.views):
        assert torch.equal(va.image, vb.image) and np.array_equal(va.invdepth, vb.invdepth)
    assert a.info.points.shape == (cfg["n_ground"] + cfg["n_structs"] * cfg["per_struct"], 3)
    assert a.neighbors == b.neighbors


def test_paths_are_fixed():
    a = flight.orbit(24, 9.0, 6.5, 30.0, 45.0, 64, 36, 42.0)
    b = flight.fly_through(40, 20, 12.0, 0.75, 6.5, 30.0, 45.0, 64, 36, 42.0)
    assert len(a) == 24 and len(b) == 40
    # an orbit's poses are distinct, each looks below the horizon
    assert len({tuple(np.round(p.centre, 6)) for p in a}) == 24
    assert all(p.R[2][2] < 0 for p in a + b)
    grid = flight.lawnmower(13, 6, 12.0, 0.75, 6.5, 30.0, 1600, 1200, 1066.6667)
    assert len(grid) == 78
    tilt = [np.degrees(np.arccos(-p.R[2][2])) for p in grid]
    assert max(tilt[1::2]) == pytest.approx(30.0, abs=1e-6) and max(tilt[0::2]) < 2.0


def test_blend_bound_matches_hand_counts():
    # 2 reached instances on a 32x32 tile: 2048 live pairs, 500 open
    b = ys.blend_bound(bytes_moved=3.35e9, counts=(2048, 700, 500), tile=32, ops_live=16, ops_kept=23, sfu_kept=2)
    assert b["ops"] == 500 * 39 + 2 * 32 * 84
    assert b["sfu"] == 500 * 3 + 2 * 3
    assert b["bound_ms"] == pytest.approx(1.0)  # 3.35 GB at 3.35 TB/s


def test_byte_counts_match_hand_counts():
    assert ys.fwd_blend_bytes(10, 4, 2, 16) == 10 * 4 + 2 * 2 * 4 + 4 * 64 + 2 * 256 * 64 + 10 * 4
    assert ys.bwd_blend_bytes(10, 4, 2, 16, 12) == 10 * 4 + 2 * 2 * 4 + 4 * 64 + 2 * 256 * 48 + 12 * 4 + 12 * 64
    assert ys.pre_fwd(10) == {"ops": 4500, "bytes": 10 * 59 * 4 + 10 * 60 + 50}
    assert ys.adam(2) == {"ops": 2 * 59 * 12, "bytes": 2 * 59 * 28}


def test_step_work_is_bound_by_bytes_at_the_cells_size():
    rows, H, W = 2_097_152, 1200, 1600
    work = [ys.pre_fwd(rows), ys.pre_bwd(rows), ys.loss_stack_ops(H, W), ys.adam(rows)]
    ops, nbytes = sum(w["ops"] for w in work), sum(w["bytes"] for w in work)
    assert nbytes / ys.HBM_BYTES_S > ops / ys.FP32_FLOP_S
    assert ys.bound_ms({"ops": ops, "bytes": nbytes}) == pytest.approx(nbytes / ys.HBM_BYTES_S * 1e3)
