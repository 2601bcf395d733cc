#!/usr/bin/env python3
"""The LOD cut's interpolation kernels against their plain PyTorch
versions, on one GPU, at the post-opt cell's shapes.

    python3 tools/interp_kernel_ab.py [--seed N]

Builds the kernels (hier/interp_autograd.py's launchers, the package's
build) and prints their ptxas registers and spills. The problem: a packed
(2,020,479, 59) attribute matrix (the cell's hierarchy) and a cut of 2^21
slots laid out as expand_packed lays it out: the first 900,000 slots valid
(the cell's views keep 0.84-0.96M), their child rows ascending, each
parent the row at half its child's index, t < 1 on two fifths of them,
kids 1 to 8; the padding slots read row (slot mod P).

It checks the forward kernel against interpolate_plain and the backward
kernel against interp_plain_bwd (bitwise), and `interpolate_rowwise`, the
plain design without per-column lerps (below), against interpolate_plain
(forward) and against InterpolateRows (the gradient of the rows). Then it
times in turns (CUDA events, median of ITERS after WARMUP, the order
reversed on the second turn):

  * fwd_kernel, fwd_plain, fwd_rowwise: launch_interp_fwd;
    interpolate_plain and interpolate_rowwise (gathers and lerps, no
    autograd);
  * bwd_kernel, bwd_plain: launch_interp_bwd; interp_plain_bwd;
  * rows: accumulate_rows of both gathers and their sum, the sorted
    accumulation all paths share;
  * step_kernel, step_autograd, step_rowwise: the slots forward and
    backward through InterpolateRows, through autograd of
    interpolate_plain (what the post-opt step ran before the kernels) and
    through autograd of interpolate_rowwise.

Each kernel time is set beside two bytes bounds over 3.35 TB/s: the
least bytes (`chip_smoke.interp_bytes`: each distinct row of ri and pi
read once), and the bytes of two gathered rows a slot (`gathered_bytes`:
what the kernels read where no row comes back from a cache).
Prints the card's name and power limit first and a JSON summary last;
exits non-zero if a kernel check fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from hidegs_tpu_torch import kernel_sources  # noqa: E402
from hidegs_tpu_torch.hier import interp_autograd as ia  # noqa: E402
from hidegs_tpu_torch.hier.lod import hierarchy_opacity_correction  # noqa: E402
from hidegs_tpu_torch.raster import cuda_blend  # noqa: E402

WARMUP, ITERS = 3, 20
P, B, VALID, W = 2_020_479, 1 << 21, 900_000, 59
SH_SHAPE = (16, 3)


def problem(dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    attrs = torch.randn(P, W, generator=g, device=dev)
    attrs[:, ia.OPAC] = torch.rand(P, generator=g, device=dev)
    ri = torch.sort(torch.randperm(P, generator=g, device=dev)[:VALID]).values
    pi = ri // 2  # two children a parent, below them
    spread = torch.arange(B, device=dev) % P
    ri, pi = torch.cat([ri, spread[VALID:]]), torch.cat([pi, spread[VALID:]])
    valid = torch.arange(B, device=dev) < VALID
    t = torch.rand(B, generator=g, device=dev)
    ts = torch.where(valid & (torch.rand(B, generator=g, device=dev) < 0.4), t, 1.0)
    kids = torch.where(valid, torch.randint(1, 9, (B,), generator=g, device=dev), 1).to(torch.int32)
    return attrs, ri, pi, ts, kids, valid


def gathered_bytes():
    """(forward, backward) bytes with both rows of every slot read: the
    forward's two gathered rows, ri and pi, t, kids and valid read and the
    five outputs written; the backward's five output gradients, ri and pi,
    t, kids and valid and the quaternion and opacity columns of both rows
    read and two (B, W) rows written."""
    slot = 2 * 8 + 4 + 4 + 1
    return B * (2 * 4 * W + slot + 4 * W), B * (4 * W + slot + 2 * 4 * 5 + 2 * 4 * W)


def interpolate_rowwise(attrs, ri, pi, ts, kids, valid, sh_shape):
    """interpolate_plain's outputs as one plain design without per-column
    lerps: the parent's quaternion columns sign-flipped in one `where` over
    the gathered rows, both whole (B, W) rows lerped once, the opacity
    corrected from its column; the outputs are column views of the one
    lerped matrix."""
    row_c, row_p = attrs[ri], attrs[pi]
    dot = torch.sum(row_c[:, ia.QUAT:ia.OPAC] * row_p[:, ia.QUAT:ia.OPAC], dim=-1, keepdim=True)
    quat_cols = torch.zeros(attrs.shape[1], dtype=torch.bool, device=attrs.device)
    quat_cols[ia.QUAT:ia.OPAC] = True
    row_p = torch.where((dot < 0) & quat_cols, -row_p, row_p)
    t = ts[:, None]
    lerp = t * row_c + (1 - t) * row_p
    op = hierarchy_opacity_correction(lerp[:, ia.OPAC], ts, kids)
    op = torch.where(valid, op, torch.zeros_like(op))
    return lerp[:, 0:3], lerp[:, 3:ia.QUAT], lerp[:, ia.QUAT:ia.OPAC], op, lerp[:, ia.SH0:].reshape(-1, *sh_shape)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261019)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("interp_kernel_ab: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, f"torch {torch.__version__} cuda {torch.version.cuda}")
    cuda_blend.build(kernel_sources.SOURCES)
    ptxas = chip_smoke.ptxas_report(kernel_sources.SOURCES["interp"])
    print(f"ptxas: {ptxas}")
    slots = problem(dev, args.seed)
    attrs, ri, pi, ts, kids, valid = slots

    want = ia.interpolate_plain(*slots, SH_SHAPE)
    out = [torch.empty_like(x) for x in want]
    ia.launch_interp_fwd(*slots, out)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    grads = [torch.randn(x.shape, generator=gen, device=dev) for x in want]
    grad_c, grad_p = torch.empty(B, W, device=dev), torch.empty(B, W, device=dev)
    ia.launch_interp_bwd(*slots, grads, grad_c, grad_p)
    want_c, want_p = ia.interp_plain_bwd(*slots, *grads)
    bits = chip_smoke.int_bits
    row_out = interpolate_rowwise(*slots, SH_SHAPE)
    checks = dict(fwd_bitwise=all(torch.equal(bits(a), bits(b)) for a, b in zip(out, want, strict=True)),
                  bwd_bitwise=torch.equal(bits(grad_c), bits(want_c)) and torch.equal(bits(grad_p), bits(want_p)),
                  rowwise_fwd_bitwise=all(torch.equal(bits(a), bits(b)) for a, b in zip(row_out, want, strict=True)))
    ok = checks["fwd_bitwise"] and checks["bwd_bitwise"]
    del want, want_c, want_p, row_out

    leaf = attrs.clone().requires_grad_(True)

    def step(fn):
        outs = fn(leaf, ri, pi, ts, kids, valid, SH_SHAPE)
        return torch.autograd.grad(outs, leaf, grads)[0]

    g_kernel, g_rowwise = step(ia.InterpolateRows.apply), step(interpolate_rowwise)
    checks.update(rowwise_rows_grad_bitwise=torch.equal(bits(g_kernel), bits(g_rowwise)),
                  rowwise_rows_grad_max_abs_err=chip_smoke.max_abs_err(g_kernel, g_rowwise))
    print(json.dumps(checks))
    del g_kernel, g_rowwise

    fns = {
        "fwd_kernel": lambda: ia.launch_interp_fwd(*slots, out),
        "fwd_plain": lambda: ia.interpolate_plain(*slots, SH_SHAPE),
        "fwd_rowwise": lambda: interpolate_rowwise(*slots, SH_SHAPE),
        "bwd_kernel": lambda: ia.launch_interp_bwd(*slots, grads, grad_c, grad_p),
        "bwd_plain": lambda: ia.interp_plain_bwd(*slots, *grads),
        "rows": lambda: ia.accumulate_rows(attrs, ri, grad_c).add_(ia.accumulate_rows(attrs, pi, grad_p)),
        "step_kernel": lambda: step(ia.InterpolateRows.apply),
        "step_autograd": lambda: step(ia.interpolate_plain),
        "step_rowwise": lambda: step(interpolate_rowwise),
    }
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(chip_smoke.time_ms(fns[k], WARMUP, ITERS))
            torch.cuda.empty_cache()
    result = dict(card=smi, ptxas=ptxas, P=P, B=B, valid=VALID, checks=checks,
                  **{f"{k}_ms": v for k, v in times.items()})
    bounds = {"": chip_smoke.interp_bytes(ri, pi, W), "gathered_": gathered_bytes()}
    for kind, (fwd, bwd) in bounds.items():
        for form, nbytes in (("fwd_kernel", fwd), ("bwd_kernel", bwd)):
            bound = nbytes / chip_smoke.HBM_BYTES_S * 1e3
            result[f"{form}_{kind}bytes"] = nbytes
            result[f"{form}_{kind}bound_ms"] = bound
            result[f"{form}_of_{kind}bound"] = bound / statistics.median(times[form])
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
