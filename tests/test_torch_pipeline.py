"""Port parity: the large-scene pipeline (pipeline.py, preprocess/chunking)
of hidegs_tpu_torch against hidegs_tpu, on the CPU.

The scene is a port of the JAX suite's `two_cluster_scene`
(tests/test_pipeline.py:12-77): two clusters of 80 toy gaussians 20 units
apart, five 40x40 views on a ring around each, written as a COLMAP model by
the port; the chunker splits it into two chunks. Both packages run
`run_pipeline` on it with 3 chunk iterations, 3 post-opt iterations and the
LOD eval at tau 0 and 3.

Tolerances: chunk lists, chunk directories and `merged.hier` exactly equal
(the same numpy code on the same inputs); the chunk training and the
post-opt steps as in tests/test_torch_trainer.py (losses rtol 1e-3, the
first step's gradients normalised atol 5e-3, the parameters within 1e-2·lr
where the gradient is signal, rows without gradient bitwise unchanged);
the LOD eval's mean cut equal and its PSNR within 1e-2 dB; the `--workers 2`
fan-out (children on `--device cpu`, one torch thread each) bitwise the
sequential run.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hidegs_tpu import pipeline as jpipe
from hidegs_tpu.hier import io as jio
from hidegs_tpu.train import hier_trainer as jht
from hidegs_tpu.train import trainer as jtrainer
from hidegs_tpu_torch import convert
from hidegs_tpu_torch import pipeline as tpipe
from hidegs_tpu_torch.data import colmap
from hidegs_tpu_torch.hier import io as tio
from hidegs_tpu_torch.hier import lod as tlod
from hidegs_tpu_torch.hier.streaming import ChunkStreamer
from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.train import hier_trainer as tht
from hidegs_tpu_torch.train import trainer as ttrainer
from hidegs_tpu_torch.utils.ply import load_gaussian_arrays
from torch_scenes import write_two_cluster_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")
LR = LRConfig()
RUN = dict(chunk_size=14.0, min_n_cams=3, iterations=3, post_opt_iterations=3, capacity=256,
           max_instances=1 << 12, add_far_cams=False, log_every=1000, eval_taus=(0.0, 3.0))


@pytest.fixture(scope="module")
def two_cluster_scene(tmp_path_factory):
    return write_two_cluster_scene(tmp_path_factory.mktemp("bigscene"))


def _host(x):
    return np.array(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _record(mp, module, name, params_of, m_of, extra=lambda ts: {}):
    """Wrap module.<name> (a step function returning (state, metrics)) to
    keep each step's params, first moments, loss and `extra(state)`."""
    runs = []
    original = getattr(module, name)

    def step(*args, **kwargs):
        ts, metrics = original(*args, **kwargs)
        loss = metrics["total"] if "total" in metrics else metrics["loss"]
        runs.append(({f: _host(getattr(params_of(ts), f)) for f in FIELDS},
                     {f: _host(getattr(m_of(ts), f)) for f in FIELDS}, float(loss), extra(ts)))
        return ts, metrics

    mp.setattr(module, name, step)
    return runs


def _record_inputs(mp, module):
    """Wrap module.hier_train_step to keep each step's inputs on the host:
    the state's params, moments, step and exposure, the cut, the camera,
    the target and the keyword arguments."""
    calls = []
    original = module.hier_train_step

    def step(ts, cut, cam, gt_image, lrs, raster_cfg, **kwargs):
        calls.append(dict(
            params={f: _host(getattr(ts.params, f)) for f in FIELDS},
            m={f: _host(getattr(ts.opt.m, f)) for f in FIELDS},
            v={f: _host(getattr(ts.opt.v, f)) for f in FIELDS},
            row_step=_host(ts.opt.step), step=int(ts.step),
            exposure={k: _host(getattr(ts, k)) for k in ("exposure", "exposure_m", "exposure_v")},
            cut={k: _host(v) for k, v in cut._asdict().items()},
            cam=[_host(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)] + [cam.height, cam.width],
            gt=_host(gt_image), kwargs=kwargs))
        return original(ts, cut, cam, gt_image, lrs, raster_cfg, **kwargs)

    mp.setattr(module, "hier_train_step", step)
    return calls


def _run(mod, trainer_mod, ht_mod, out, source, **kw):
    with pytest.MonkeyPatch.context() as mp:
        steps = _record(mp, trainer_mod, "train_step", lambda ts: ts.gaussians.params, lambda ts: ts.opt.m,
                        lambda ts: {"alive": _host(ts.gaussians.alive),
                                    "lr_scale": float(ts.gaussians.spatial_lr_scale)})
        post = _record(mp, ht_mod, "hier_train_step", lambda ts: ts.params, lambda ts: ts.opt.m)
        post_inputs = _record_inputs(mp, ht_mod)
        mod.run_pipeline(source, out, **{**RUN, **kw})
    return dict(out=out, steps=steps, post=post, post_inputs=post_inputs,
                meta=json.load(open(os.path.join(out, "pipeline.json"))))


def port_step_from_jax_inputs(call, h):
    """The port's hier_train_step on the inputs one JAX step was given."""
    ts = tht.state_from_hierarchy(tio.Hierarchy(*h), num_images=len(call["exposure"]["exposure"]), device="cpu")
    gp = type(ts.params)
    ts = ts._replace(
        params=gp(*(torch.as_tensor(call["params"][f]) for f in FIELDS)),
        opt=ts.opt._replace(m=gp(*(torch.as_tensor(call["m"][f]) for f in FIELDS)),
                            v=gp(*(torch.as_tensor(call["v"][f]) for f in FIELDS)),
                            step=torch.as_tensor(call["row_step"])),
        step=torch.tensor(call["step"], dtype=torch.int32),
        **{k: torch.as_tensor(v) for k, v in call["exposure"].items()})
    cut = tlod.HierCut(**{k: torch.as_tensor(v) for k, v in call["cut"].items()})
    cam = convert.camera_from_jax(*call["cam"], device="cpu")
    new, m = tht.hier_train_step(ts, cut, cam, torch.as_tensor(call["gt"]), lr_tree(ts.step, LR, 1.0),
                                 RasterConfig(max_instances=RUN["max_instances"]), **call["kwargs"])
    return ({f: _host(getattr(new.params, f)) for f in FIELDS}, {f: _host(getattr(new.opt.m, f)) for f in FIELDS},
            float(m["loss"]), {})


@pytest.fixture(scope="module")
def jax_run(two_cluster_scene, tmp_path_factory):
    return _run(jpipe, jtrainer, jht, str(tmp_path_factory.mktemp("jax") / "out"), two_cluster_scene)


@pytest.fixture(scope="module")
def port_run(two_cluster_scene, tmp_path_factory):
    return _run(tpipe, ttrainer, tht, str(tmp_path_factory.mktemp("port") / "out"), two_cluster_scene,
                device="cpu")


def leaf_scale(step, f):
    """The |grad| that normalises leaf `f` of one (params, m, loss) record:
    its own max, except where that max is float noise, below 1e-6 of the
    largest leaf's (the rotations of a freshly initialised chunk, whose
    isotropic KNN scales give them no gradient in exact arithmetic): there
    1e-3 of the largest leaf's max, so that no row of it counts as signal."""
    own = np.abs(step[1][f]).max()
    big = max(np.abs(step[1][g]).max() for g in FIELDS)
    return max(own, 1e-3 * big) if own < 1e-6 * big else max(own, 1e-30)


def signal_rows(jsteps, f):
    """The elements of leaf `f` whose |m| is above 1e-1 of `leaf_scale` on
    every step (the signal rule of tests/test_torch_trainer.py)."""
    return np.all([np.abs(s[1][f]) > 1e-1 * leaf_scale(s, f) for s in jsteps], axis=0)


def assert_steps_match(jsteps, tsteps, leaf_lr):
    """Losses, the first step's gradients and the last parameters of two
    runs of (params, m, loss) records."""
    assert len(jsteps) == len(tsteps) > 0
    for k, (j, t) in enumerate(zip(jsteps, tsteps)):
        np.testing.assert_allclose(t[2], j[2], rtol=1e-3, err_msg=f"step {k} loss")
    for f in FIELDS:
        want = jsteps[0][1][f]
        scale = leaf_scale(jsteps[0], f)
        np.testing.assert_allclose(tsteps[0][1][f] / scale, want / scale, atol=5e-3, err_msg=f"step-1 grad {f}")
        signal = signal_rows(jsteps, f)
        still = np.all([s[1][f] == 0 for s in jsteps], axis=0)
        got, want = tsteps[-1][0][f], jsteps[-1][0][f]
        np.testing.assert_allclose(got[signal], want[signal], rtol=0, atol=1e-2 * leaf_lr[f], err_msg=f)
        assert np.array_equal(got[still], want[still]), f"{f} moved without gradient"


def _chunk_files(out):
    root = os.path.join(out, "chunks")
    found = {}
    for d, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), root)
            if os.sep + "trained" + os.sep not in os.sep + rel and not name.endswith(".hier"):
                found[rel] = open(os.path.join(d, name), "rb").read()
    return found


def test_chunk_lists_and_directories_match_jax(jax_run, port_run):
    assert port_run["meta"]["chunks"] == jax_run["meta"]["chunks"]
    assert len(port_run["meta"]["chunks"]) == 2
    jfiles, tfiles = _chunk_files(jax_run["out"]), _chunk_files(port_run["out"])
    assert sorted(tfiles) == sorted(jfiles) and any(k.endswith("points3D.bin") for k in tfiles)
    for rel in jfiles:
        assert tfiles[rel] == jfiles[rel], rel
    assert len(ChunkStreamer(os.path.join(port_run["out"], "chunks"), device="cpu").chunks) == 2


def test_chunk_training_matches_jax(jax_run, port_run):
    """Each chunk's 3 train steps; each PLY holds its run's last state."""
    js, ts = jax_run["steps"], port_run["steps"]
    chunks = jax_run["meta"]["chunks"]
    assert len(js) == len(ts) == 3 * len(chunks)
    for c, (i, j) in enumerate(chunks):
        jrun, trun = js[3 * c:3 * c + 3], ts[3 * c:3 * c + 3]
        scale = trun[0][3]["lr_scale"]
        np.testing.assert_allclose(scale, jrun[0][3]["lr_scale"], rtol=1e-6)
        leaf_lr = {"xyz": LR.position_lr_init * scale, "sh_dc": LR.feature_lr,
                   "sh_rest": LR.feature_lr / LR.feature_rest_div, "scaling": LR.scaling_lr,
                   "rotation": LR.rotation_lr, "opacity": LR.opacity_lr}
        assert_steps_match(jrun, trun, leaf_lr)
        rel = os.path.join("chunks", f"chunk_{i}_{j}", "trained", "point_cloud", "iteration_3", "point_cloud.ply")
        for run, last in ((jax_run, jrun[-1]), (port_run, trun[-1])):
            ply = load_gaussian_arrays(os.path.join(run["out"], rel))
            alive = last[3]["alive"]
            for f in FIELDS:
                assert np.array_equal(ply[f].reshape(last[0][f][alive].shape), last[0][f][alive]), (run["out"], f)


def test_resume_from_jax_chunk_hierarchies(two_cluster_scene, jax_run, tmp_path):
    """The port's run_pipeline seeded with the JAX run's chunk hierarchies
    (the fan-out resume path): merged.hier bitwise; each of the JAX run's 3
    post-opt steps, fed to the port's step, within the step tolerance; the
    port's own 3-step merged_opt.hier against JAX's: the same topology,
    every field within 1e-2·lr on the rows whose gradient is signal on
    every step, bitwise on the rows neither run gave a gradient;
    evaluate_lod of both packages on the JAX run's merged_opt.hier: cuts
    equal, PSNR within 1e-2 dB.

    On this scene the JAX step gives a few rendered rows a gradient of
    ~1e-13 (below 1e-9 of the leaf's largest) where the port's is exactly 0,
    and Adam (eps 1e-15) turns that noise into a full learning-rate step
    (opacity ±0.05). The test checks that these are the only rows on which
    the two runs' first two steps differ in having a gradient. In the
    chained runs the rows so moved change the third step's render: its loss
    departs a few percent, and rows first seen on that step take different
    steps. Those rows are not signal on every step, so the file is held on
    the others; each step alone is held from JAX's input state."""
    out = str(tmp_path / "out")
    for i, j in jax_run["meta"]["chunks"]:
        d = os.path.join(out, "chunks", f"chunk_{i}_{j}")
        os.makedirs(d)
        shutil.copy(os.path.join(jax_run["out"], "chunks", f"chunk_{i}_{j}", "hierarchy.hier"), d)
    run = _run(tpipe, ttrainer, tht, out, two_cluster_scene, device="cpu")
    assert run["steps"] == []  # every chunk resumed
    with open(os.path.join(out, "merged.hier"), "rb") as f, open(os.path.join(jax_run["out"], "merged.hier"), "rb") as g:
        assert f.read() == g.read()
    leaf_lr = {"xyz": LR.position_lr_init, "sh_dc": LR.feature_lr, "sh_rest": LR.feature_lr / LR.feature_rest_div,
               "scaling": LR.scaling_lr, "rotation": LR.rotation_lr, "opacity": LR.opacity_lr}
    h = jio.read_hier(os.path.join(out, "merged.hier"))
    assert len(run["post"]) == len(jax_run["post"]) == len(jax_run["post_inputs"]) == 3
    assert [c["cut"]["render_indices"].tolist() for c in run["post_inputs"]] == \
        [c["cut"]["render_indices"].tolist() for c in jax_run["post_inputs"]]
    for call, jstep in zip(jax_run["post_inputs"], jax_run["post"]):
        assert call["kwargs"]["optimize_exposure"] and call["kwargs"]["use_exposure"]
        assert_steps_match([jstep], [port_step_from_jax_inputs(call, h)], leaf_lr)
    # the port's own 3-step run against JAX's: up to step 2 the runs give
    # a row a gradient alike but for JAX's noise rows; from step 3 on the
    # rows those moved change the render, and with it the loss
    tpost, jpost = run["post"], jax_run["post"]
    for k in (0, 1):
        np.testing.assert_allclose(tpost[k][2], jpost[k][2], rtol=1e-3, err_msg=f"chained step {k} loss")
        for f in FIELDS:
            jm, tm = jpost[k][1][f], tpost[k][1][f]
            differ = (jm != 0) != (tm != 0)
            assert (tm[differ] == 0).all() and (np.abs(jm[differ]) < 1e-9 * np.abs(jm).max()).all(), (k, f)
    th = tio.read_hier(os.path.join(out, "merged_opt.hier"))
    jh = jio.read_hier(os.path.join(jax_run["out"], "merged_opt.hier"))
    np.testing.assert_array_equal(th.nodes, jh.nodes)
    np.testing.assert_array_equal(th.boxes, jh.boxes)

    def leaves(x):  # merged_opt.hier's fields by the parameter each holds
        return {"xyz": x.pos, "sh_dc": x.shs[:, 0], "sh_rest": x.shs[:, 1:], "scaling": x.scale,
                "rotation": x.rot, "opacity": x.alpha}

    tl, jl = leaves(th), leaves(jh)
    for f in FIELDS:
        signal = signal_rows(jpost, f).reshape(jl[f].shape)
        still = np.all([s[1][f] == 0 for s in jpost + tpost], axis=0).reshape(jl[f].shape)
        if f == "rotation":  # the file holds normalised rows: a row is held where any element is signal
            signal = np.broadcast_to(signal.any(1, keepdims=True), signal.shape)
            still = np.broadcast_to(still.all(1, keepdims=True), still.shape)
        assert signal.any(), f
        np.testing.assert_allclose(tl[f][signal], jl[f][signal], rtol=0, atol=1e-2 * leaf_lr[f], err_msg=f)
        if f == "rotation":  # the rows unmoved, normalised by XLA's rsqrt and by torch's
            assert np.array_equal(tpost[-1][0][f][still[:, 0]], jpost[-1][0][f][still[:, 0]]), f
            np.testing.assert_array_max_ulp(tl[f][still], jl[f][still], maxulp=2)
        else:
            assert np.array_equal(tl[f][still], jl[f][still]), f"{f} moved without gradient"
    assert [r["mean_cut"] for r in run["meta"]["lod_eval"]] == [r["mean_cut"] for r in jax_run["meta"]["lod_eval"]]
    assert sorted(run["meta"]) == sorted(jax_run["meta"])
    jpath = os.path.join(jax_run["out"], "merged_opt.hier")
    jrep = jpipe.evaluate_lod(jpath, two_cluster_scene, max_instances=RUN["max_instances"], taus=RUN["eval_taus"])
    trep = tpipe.evaluate_lod(jpath, two_cluster_scene, max_instances=RUN["max_instances"], taus=RUN["eval_taus"],
                              device="cpu")
    assert [r["mean_cut"] for r in trep] == [r["mean_cut"] for r in jrep] and jrep[-1]["mean_cut"] > 0
    for trow, jrow in zip(trep, jrep):
        assert trow["tau"] == jrow["tau"] and abs(trow["psnr"] - jrow["psnr"]) < 1e-2, (trow, jrow)


def test_fanout_cli_matches_sequential(two_cluster_scene, jax_run, port_run, tmp_path):
    """`python -m hidegs_tpu_torch.pipeline --workers 2 --device cpu`: the
    children train on the CPU with one torch thread, and the merged
    hierarchy is bitwise the sequential in-process run's; pipeline.json has
    the JAX pipeline's keys."""
    out = str(tmp_path / "fan")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "hidegs_tpu_torch.pipeline", "--source_path", two_cluster_scene,
           "--output_path", out, "--chunk_size", "14", "--min_n_cams", "3", "--iterations", "3",
           "--post_opt_iterations", "3", "--capacity", "256", "--max_instances", str(1 << 12),
           "--eval_taus", "0", "3", "--workers", "2", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("worker started") == 2 and "--device" not in proc.stderr
    meta = json.load(open(os.path.join(out, "pipeline.json")))
    assert sorted(meta) == sorted(jax_run["meta"]) and meta["chunks"] == port_run["meta"]["chunks"]
    for name in ("merged.hier", "merged_opt.hier"):
        with open(os.path.join(out, name), "rb") as f, open(os.path.join(port_run["out"], name), "rb") as g:
            assert f.read() == g.read(), name
    assert meta["lod_eval"] == port_run["meta"]["lod_eval"]


def test_chunk_worker_cli_is_idempotent(two_cluster_scene, tmp_path):
    """`--chunk i j` worker mode trains exactly one chunk; run again, it
    returns at once (fan-out retry and resume)."""
    import time

    from hidegs_tpu_torch.preprocess import chunking

    out = tmp_path / "out"
    cams, imgs, (xyz, rgb, err, _ids) = colmap.read_model(os.path.join(two_cluster_scene, "sparse", "0"))
    chunks = chunking.compute_chunks(cams, imgs, xyz, err, chunk_size=14.0, min_n_cams=3, add_far_cams=False)
    chunking.write_chunks(chunks, cams, imgs, xyz, rgb, err, str(out / "chunks"))
    ch = chunks[0]
    argv = ["--source_path", two_cluster_scene, "--output_path", str(out), "--chunk", str(ch.i), str(ch.j),
            "--iterations", "3", "--capacity", "256", "--max_instances", str(1 << 12), "--device", "cpu"]
    tpipe.main(argv)
    hier = out / "chunks" / f"chunk_{ch.i}_{ch.j}" / "hierarchy.hier"
    first = hier.read_bytes()
    assert tio.read_hier(str(hier)).num_points > 0
    others = [p for p in (out / "chunks").glob("chunk_*/hierarchy.hier") if p != hier]
    assert others == []
    t0 = time.time()
    tpipe.main(argv)
    assert time.time() - t0 < 5.0 and hier.read_bytes() == first
