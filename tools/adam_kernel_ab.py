#!/usr/bin/env python3
"""The masked Adam kernel against its plain PyTorch body, on one GPU, at
the row counts and gradient layouts of the train and post-opt cells.

    python3 tools/adam_kernel_ab.py [--seed N]

Builds the kernel (model/adam.py's launcher, the package's build) and
prints its ptxas registers and spills. Then for each shape:

  * "postopt": 2,020,479 rows (the cell's hierarchy), the xyz, sh_dc and
    sh_rest gradients sliced out of one packed (rows, 59) matrix, as the
    post-opt step's are;
  * "train": 2^21 rows (the train cell's row budget), params and moments
    the first rows of longer buffers, sh_dc and sh_rest sliced out of one
    (rows, 16, 3) gradient, as the train step's are;

(chip_smoke.adam_problem, which phase 1a of the smoke holds and times too)

and each share of rows in the mask (all rows, a random half), it checks
that masked_adam_update (one launch) and its in-place form are bitwise
masked_adam_plain, then times in turns (plain, kernel, kernel, plain;
CUDA events, median of ITERS after WARMUP): the plain body, the whole
out-of-place update (bias corrections, outputs and the launch), the
kernel alone out of place, and the kernel alone in place (the form a step
that donates its state runs). Each kernel time is set beside its bytes
bound: the bytes the mask needs (p, m and v read and written for every
row, or only for rows in the mask in place; the gradient and the bias
corrections for rows in the mask; the mask; chip_smoke.adam_bytes) over
3.35 TB/s.

Prints the card's name and power limit first and a JSON summary last;
exits non-zero if any result differs from the plain body.
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
from hidegs_tpu_torch import kernel_sources  # noqa: E402
from hidegs_tpu_torch.model import adam  # noqa: E402
from hidegs_tpu_torch.model.gaussians import GaussianParams  # noqa: E402
from hidegs_tpu_torch.raster import cuda_blend  # noqa: E402

WARMUP, ITERS = 3, 20
SHARES = (1.0, 0.5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adam_kernel_ab: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    cuda_blend.build(kernel_sources.SOURCES)
    ptxas = chip_smoke.ptxas_report(kernel_sources.SOURCES["masked_adam"])
    print(f"ptxas: {ptxas}")
    results, ok = [], True
    for shape, rows in chip_smoke.ADAM_ROWS.items():
        for share in SHARES:
            params, g, opt, lr, visible, _ = chip_smoke.adam_problem(dev, shape, share, args.seed)
            want = chip_smoke.adam_leaves(*adam.masked_adam_plain(params, g, opt, lr, visible))
            got = chip_smoke.adam_leaves(*adam.masked_adam_update(params, g, opt, lr, visible))
            bitwise = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
            donated = [x.clone() for x in chip_smoke.adam_leaves(params, opt)]
            dp = GaussianParams(*donated[:6])
            dopt = adam.AdamState(GaussianParams(*donated[6:12]), GaussianParams(*donated[12:18]), donated[18])
            in_place = chip_smoke.adam_leaves(*adam.masked_adam_update(dp, g, dopt, lr, visible, in_place=True))
            bitwise_in_place = all(torch.equal(a, b) for a, b in zip(in_place, want, strict=True))
            ok &= bitwise and bitwise_in_place
            del got, in_place, want
            _, c1, c2 = adam.bias_corrections(opt.step, visible, 0.9, 0.999)
            out = tuple(GaussianParams(*(torch.empty_like(x) for x in t)) for t in (params, opt.m, opt.v))
            scratch = [x.clone() for x in chip_smoke.adam_leaves(params, opt)]
            sp, sm, sv = (GaussianParams(*scratch[k:k + 6]) for k in (0, 6, 12))
            fns = {
                "plain": lambda: adam.masked_adam_plain(params, g, opt, lr, visible),
                "update": lambda: adam.masked_adam_update(params, g, opt, lr, visible),
                "kernel": lambda: adam.launch_masked_adam(params, g, opt.m, opt.v, lr, visible, c1, c2, *out,
                                                          0.9, 0.999, 1e-15),
                "kernel_in_place": lambda: adam.launch_masked_adam(sp, g, sm, sv, lr, visible, c1, c2, sp, sm, sv,
                                                                   0.9, 0.999, 1e-15),
            }
            times = {k: [] for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for k in order:
                    times[k].append(chip_smoke.time_ms(fns[k], WARMUP, ITERS))
            row = dict(shape=shape, rows=rows, share=share, n_visible=int(visible.sum()), bitwise=bitwise,
                       bitwise_in_place=bitwise_in_place, **{f"{k}_ms": v for k, v in times.items()})
            for form, in_place_form in (("kernel", False), ("kernel_in_place", True)):
                share_in = float(visible.float().mean())
                bound = chip_smoke.adam_bytes(rows, share_in, in_place_form) / chip_smoke.HBM_BYTES_S * 1e3
                best = min(times[form])
                row[f"{form}_bound_ms"] = bound
                row[f"{form}_of_bound"] = bound / best
            results.append(row)
            print(json.dumps(row))
            del params, g, opt, out, scratch, sp, sm, sv, dp, dopt, donated, c1, c2
            torch.cuda.empty_cache()
    print(json.dumps(dict(card=smi, ptxas=ptxas, results=results, bitwise=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
