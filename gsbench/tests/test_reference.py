"""The frozen reference against the program's eager CPU path at toy sizes:
a render, a train step and a LOD cut."""
import numpy as np
import pytest
import torch

from gsbench.scenes import flight, uav


def toy_model(seed=3):
    return uav.make_uav_gaussians(seed, "cpu", n_ground=3000, n_structs=4, per_struct=40)


def toy_pose():
    return flight.orbit(8, 9.0, 6.5, 30.0, 45.0, 80, 48, 52.0)[1]


def program_camera(p):
    from hidegs_tpu_torch.core.camera_math import make_camera

    return make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width, device="cpu")


def test_render_agrees_with_the_program():
    from hidegs_tpu_torch.raster.api import RasterConfig, render

    from gsbench.checks import common
    from gsbench.reference.raster.api import render as ref_render

    arrays, p = toy_model(), toy_pose()
    cfg = RasterConfig(max_instances=1 << 16)
    with torch.no_grad():
        got = render(*arrays, program_camera(p), config=cfg, render_geo=True)
        want = ref_render(*arrays, common.ref_camera(p, "cpu"), config=common.ref_config(cfg), render_geo=True)
    for k in ("render", "invdepth", "alpha", "rendered_normal"):
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-5)
    assert int(got["overflow"]) == 0


def test_train_step_agrees_with_the_program():
    from hidegs_tpu_torch.model.gaussians import init_from_points
    from hidegs_tpu_torch.raster.api import RasterConfig
    from hidegs_tpu_torch.train import loop

    from gsbench.checks import common
    from gsbench.reference.model.gaussians import init_from_points as ref_init
    from gsbench.reference.train import loop as ref_loop

    arrays, p = toy_model(), toy_pose()
    pts, cols = arrays[0], torch.sigmoid(arrays[4][:, 0])
    cfg = loop.TrainConfig(raster=RasterConfig(max_instances=1 << 16))
    rcfg = ref_loop.TrainConfig(raster=common.ref_config(cfg.raster))
    target = torch.rand((3, p.height, p.width), generator=torch.Generator().manual_seed(1))
    ts = loop.init_train_state(init_from_points(pts, cols, capacity=4096, spatial_lr_scale=10.0), 1)
    rts = ref_loop.init_train_state(ref_init(pts, cols, capacity=4096, spatial_lr_scale=10.0), 1)
    batch = loop.ViewBatch(cam=program_camera(p), image=target, image_idx=torch.zeros((), dtype=torch.int64))
    rbatch = ref_loop.ViewBatch(cam=common.ref_camera(p, "cpu"), image=target,
                                image_idx=torch.zeros((), dtype=torch.int64))
    new, m = loop.train_step(ts, batch, cfg)
    rnew, rm = ref_loop.train_step(rts, rbatch, rcfg)
    assert float(m["total"]) == pytest.approx(float(rm["total"]), rel=1e-6)
    for a, b in zip(new.opt.m, rnew.opt.m):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-4)
    for a, b in zip(new.gaussians.params, rnew.gaussians.params):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_lod_cut_and_frame_agree_with_the_program():
    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer
    from hidegs_tpu_torch.hier.io import Hierarchy

    from gsbench.checks import lod as lod_check
    from gsbench.scenes import hierarchy

    arrays, p = toy_model(), toy_pose()
    means, scales, quats, opacities, shs = (a.numpy() for a in arrays)
    fields = hierarchy.build_hierarchy(means, quats, scales, opacities, shs)
    assert len(fields["nodes"]) > len(fields["pos"]) // 2
    renderer = AdaptiveHierRenderer.from_hierarchy(Hierarchy(**fields), "cpu")
    for tau in (0.0, 6.0, 15.0):
        with torch.no_grad():
            out = renderer.render(program_camera(p), tau)
        got = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8).permute(1, 2, 0).numpy()
        want = lod_check.reference_image(fields, p, tau, "cpu")
        _, n_cut = lod_check.reference_cut(fields, p, tau, "cpu")[1:]
        assert int(out["num_selected"]) == n_cut
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
