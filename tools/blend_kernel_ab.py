#!/usr/bin/env python3
"""The blend kernels of this checkout against other versions of their
sources, on one GPU, at the full-width render cell of chip_smoke.py.

    mkdir -p build/ref_src/<tag>
    git show <rev>:hidegs_tpu_torch/raster/csrc/blend_fwd.cu > build/ref_src/<tag>/blend_fwd.cu
    git show <rev>:hidegs_tpu_torch/raster/csrc/blend_bwd.cu > build/ref_src/<tag>/blend_bwd.cu
    python3 tools/blend_kernel_ab.py --ref-src build/ref_src/<tag> [--ref-src DIR ...]

Builds every version with cuda_blend.build (the same flags, one nvcc per
source, all at once) and prints each library's ptxas registers and spills.
Then, on view 0 of the 1,010,240-gaussian cell (1920x1088, tile 32), each
reference (named by its directory) against this checkout:

  * forward: the planes and per-instance observe counts, which must be
    bitwise equal, and the times in turns (ref, this, this, ref; CUDA
    events, median of ITERS after WARMUP launches each);
  * backward: the gradient rows on seeded cotangents, their largest
    difference per column normalised by the column's max and the count of
    rows that differ at all, two runs of this checkout's kernel bitwise
    equal, and the times in turns. A version whose backward takes the
    expansion slots (`slot_s` in its source) writes its rows in expansion
    order; the others in sorted-instance order, and their rows are compared
    in that order;
  * fold: each version's fold kernel on this checkout's expansion-order
    rows, which must be bitwise equal, and the times in turns, one launch
    at a time (chip_smoke.time_ms) and per launch over runs of 20
    back-to-back launches (chip_smoke.time_per_launch_ms).

Prints the card's name and power limit first and a JSON summary last; exits
non-zero if a forward or a fold differs or the backward is not
reproducible.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from hidegs_tpu_torch.raster import binning, blend_plain, cuda_blend  # noqa: E402
from hidegs_tpu_torch.raster.preprocess import preprocess_gaussians  # noqa: E402

WARMUP, ITERS = 3, 20
NEW = "this"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-src", type=Path, action="append", required=True,
                    help="directory with a reference blend_fwd.cu and blend_bwd.cu (repeat for more)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("blend_kernel_ab: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    versions = {NEW: cuda_blend.SOURCES}
    versions.update({d.name: {name: d.resolve() / f"{name}.cu" for name in cuda_blend.SOURCES} for d in args.ref_src})
    libs = cuda_blend.build({f"{tag}:{name}": src for tag, srcs in versions.items() for name, src in srcs.items()})
    for key, lib in libs.items():
        print(f"[ptxas] {key}: {chip_smoke.usage_report(chip_smoke.ptxas_usage(lib))}")
    by_slot = {tag: "slot_s" in srcs["blend_bwd"].read_text() for tag, srcs in versions.items()}
    fns = {(tag, name): cuda_blend.bind(libs[f"{tag}:{name}"], f"hidegs_{name}", 4, 3,
                                        4 if name == "blend_bwd" and by_slot[tag] else 3)
           for tag in versions for name in ("blend_fwd", "blend_bwd")}
    refs = [tag for tag in versions if tag != NEW]

    scene, cams, cfg = chip_smoke.full_width_setup(dev)
    cam, tile = cams[0], cfg.tile
    ty, tx = binning.tile_grid(cam.height, cam.width, tile)
    T, P = ty * tx, tile * tile
    pre = preprocess_gaussians(*scene, cam, active_sh_degree=3, render_geo=True,
                               screen_bounds=(tx * tile, ty * tile))
    tb = binning.bin_gaussians(pre, ty, tx, cfg.max_instances, tile, depth_bits=cfg.depth_sort_bits)
    count = cuda_blend.visited_count(tb, cfg.max_blocks)
    stream_in = (blend_plain.pack_gaussian_attrs(pre), tb.gauss_id.contiguous(), tb.tile_start.contiguous(), count)
    I = tb.gauss_id.shape[0]
    slot_s = tb.slot_s.contiguous()
    del scene, pre
    stream = torch.cuda.current_stream().cuda_stream

    def run(tag, name, a, b):
        """One launch of version `tag`'s kernel `name` with outputs/extra
        inputs a, b (forward: planes, observe; backward: g_aug, rows);
        zeroes the accumulated output b first."""
        b.zero_()
        slot = (slot_s.data_ptr(),) if name == "blend_bwd" and by_slot[tag] else ()
        rc = fns[tag, name](*(x.data_ptr() for x in stream_in), T, tx, tile, *slot, a.data_ptr(), b.data_ptr(),
                            stream)
        if rc != 0:
            raise RuntimeError(f"{tag} {name} launch failed: cudaError {rc}")

    def turns(name, outs):
        ms = {tag: [] for tag in versions}
        for r in refs:
            for tag in (r, NEW, NEW, r):
                ms[tag].append(chip_smoke.time_ms(lambda: run(tag, name, *outs[tag]), WARMUP, ITERS))
            print(f"[{name}] ms in turns ({r}, {NEW}, {NEW}, {r}): "
                  + ", ".join(f"{x:.4f}" for x in (ms[r][0], ms[NEW][-2], ms[NEW][-1], ms[r][1])))
        return ms

    outs = {tag: (torch.empty((T, P, blend_plain.OUT_CH), device=dev), torch.zeros((I,), dtype=torch.int32, device=dev))
            for tag in versions}
    for tag in versions:
        run(tag, "blend_fwd", *outs[tag])
    fwd_equal = {}
    for r in refs:
        planes_diff = int((outs[r][0] != outs[NEW][0]).sum())
        obs_diff = int((outs[r][1] != outs[NEW][1]).sum())
        fwd_equal[r] = planes_diff == 0 and obs_diff == 0
        print(f"[blend_fwd] {r}: {planes_diff} plane values and {obs_diff} observe counts differ from {NEW} "
              f"checkout's")
    fwd_ms = turns("blend_fwd", outs)

    g = torch.randn(outs[NEW][0].shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    g[..., 10:] = 0.0
    g_aug = blend_plain.augment_cotangents(outs[NEW][0], g)
    del outs, g
    rows = {tag: (g_aug, torch.zeros((I, blend_plain.ATTR), device=dev)) for tag in versions}
    for tag in versions:
        run(tag, "blend_bwd", *rows[tag])
    again = torch.zeros_like(rows[NEW][1])
    run(NEW, "blend_bwd", g_aug, again)
    bwd_repro = torch.equal(again, rows[NEW][1])
    bwd_diff = {}

    def sorted_rows(tag):  # every version's rows in sorted-instance order
        return rows[tag][1][slot_s.long()] if by_slot[tag] else rows[tag][1]

    for r in refs:
        want, got = sorted_rows(r), sorted_rows(NEW)
        bwd_diff[r] = max(float((got[:, c] - want[:, c]).abs().max()) / (float(want[:, c].abs().max()) + 1e-30)
                          for c in range(blend_plain.GRAD_COLS))
        n_rows = int((got != want).any(dim=1).sum())
        print(f"[blend_bwd] {r}: rows differ from {NEW} checkout's by at most {bwd_diff[r]:.3e} of a column's max; "
              f"{n_rows} of {I} rows differ at all")
    print(f"[blend_bwd] two runs of {NEW} checkout's kernel bitwise equal: {bwd_repro}")
    bwd_ms = turns("blend_bwd", rows)

    # every version's fold on this checkout's expansion-order rows
    rows_exp, g_start, N = rows[NEW][1], tb.g_start.contiguous(), stream_in[0].shape[0]
    del rows, g_aug
    folds = {tag: (cuda_blend.bind(libs[f"{tag}:blend_bwd"], "hidegs_fold_rows", 2, 1, 2),
                   torch.empty((N, blend_plain.ATTR), device=dev)) for tag in versions}

    def fold(tag):
        fn, out = folds[tag]
        rc = fn(rows_exp.data_ptr(), g_start.data_ptr(), N, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{tag} fold launch failed: cudaError {rc}")

    for tag in versions:
        fold(tag)
    fold_equal = {r: torch.equal(folds[r][1], folds[NEW][1]) for r in refs}
    fold_ms = {}
    for timer in (chip_smoke.time_ms, chip_smoke.time_per_launch_ms):
        ms = {tag: [] for tag in versions}
        for r in refs:
            for tag in (r, NEW, NEW, r):
                ms[tag].append(timer(lambda: fold(tag), warmup=WARMUP, iters=ITERS))
            print(f"[fold_rows] {r}: bitwise {NEW} checkout's: {fold_equal[r]}; {timer.__name__} in turns ({r}, "
                  f"{NEW}, {NEW}, {r}): " + ", ".join(f"{x:.4f}" for x in (ms[r][0], ms[NEW][-2], ms[NEW][-1], ms[r][1])))
        fold_ms[timer.__name__] = ms

    print(json.dumps(dict(card=smi, fwd_bitwise_equal=fwd_equal, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                          bwd_max_norm_diff=bwd_diff, bwd_two_runs_equal=bwd_repro, fold_bitwise_equal=fold_equal,
                          fold_ms=fold_ms)))
    return 0 if all(fwd_equal.values()) and bwd_repro and all(fold_equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
