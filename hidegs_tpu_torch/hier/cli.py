"""Hierarchy CLI tools — GaussianHierarchyCreator / GaussianHierarchyMerger
equivalents (mainHierarchyCreator.cpp:38, mainHierarchyMerger.cpp:44).

The port's own copy of hidegs_tpu/hier/cli.py: `create` builds with the
port's native builder (hier/build.py) and reads camera centres through the
port's `load_scene`; the files it writes are byte-for-byte the JAX CLI's.

    python -m hidegs_tpu_torch.hier.cli create --ply trained/point_cloud.ply \
        --out hierarchy.hier
    python -m hidegs_tpu_torch.hier.cli merge --chunks chunks_dir --out merged.hier

`create` reads a trained 3DGS ply (activations applied), builds the kd-tree +
cluster-merge hierarchy (native C++ when available), writes `.hier`.
`merge` scans chunk_*/ subdirs for hierarchy.hier + center.txt/extent.txt and
stitches them under a global root.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def cmd_create(args):
    from hidegs_tpu_torch.hier.build import build_hierarchy
    from hidegs_tpu_torch.hier.io import write_anchors, write_hier
    from hidegs_tpu_torch.hier.refine import align_rotations, appearance_filter, compute_anchors
    from hidegs_tpu_torch.utils.ply import load_gaussian_arrays

    d = load_gaussian_arrays(args.ply)
    n = len(d["xyz"])
    shs = np.concatenate([d["sh_dc"][:, None, :], d["sh_rest"]], axis=1)
    opac = 1.0 / (1.0 + np.exp(-d["opacity"]))
    scales = np.exp(d["scaling"])
    h = build_hierarchy(d["xyz"], d["rotation"], scales, opac, shs)
    if not args.no_align:
        # reference always sign-aligns rotations after merging
        # (mainHierarchyCreator.cpp:146-147)
        h = align_rotations(h)
    if args.cameras:
        # per-camera granularity filter + anchors
        # (mainHierarchyCreator.cpp:150-158)
        from hidegs_tpu_torch.data.scene import load_scene

        scene = load_scene(args.cameras)
        # the camera centres on --device, copied to the host once
        cam_pos = torch.stack([
            c.cam_params(device=args.device).camera_center for c in scene.train_cameras
        ]).cpu().numpy()
        h = appearance_filter(h, cam_pos, limit=args.filter_limit)
        anchors = compute_anchors(h, cam_pos, limit=args.filter_limit)
        write_anchors(os.path.join(os.path.dirname(args.out) or ".", "anchors.bin"), anchors)
        print(f"appearance filter: {h.num_nodes} nodes kept, {len(anchors)} anchors")
    write_hier(args.out, h)
    print(f"{args.out}: {h.num_points} gaussians ({n} leaves), {h.num_nodes} nodes")


def cmd_merge(args):
    from hidegs_tpu_torch.hier.io import read_hier, write_hier
    from hidegs_tpu_torch.hier.merge import merge_hierarchies

    chunks, centers, extents = [], [], []
    for d in sorted(glob.glob(os.path.join(args.chunks, "chunk_*"))):
        hier_path = os.path.join(d, args.hier_name)
        if not os.path.exists(hier_path):
            continue
        chunks.append(read_hier(hier_path))
        centers.append(np.loadtxt(os.path.join(d, "center.txt")).reshape(-1)[:3])
        extents.append(np.loadtxt(os.path.join(d, "extent.txt")).reshape(-1)[:3])
    if not chunks:
        raise SystemExit(f"no chunk hierarchies found under {args.chunks}")
    merged = merge_hierarchies(chunks, centers, extents, slack=args.slack)
    write_hier(args.out, merged)
    print(f"{args.out}: merged {len(chunks)} chunks → {merged.num_points} gaussians, "
          f"{merged.num_nodes} nodes")


def main(argv=None):
    p = argparse.ArgumentParser("hidegs_tpu_torch hierarchy tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("create")
    c.add_argument("--ply", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--no_align", action="store_true",
                   help="skip the parent/child rotation sign alignment")
    c.add_argument("--cameras", default="",
                   help="scene source path; enables the per-camera appearance "
                        "filter and anchors.bin output")
    c.add_argument("--filter_limit", type=float, default=5e-4)
    c.add_argument("--device", default="cuda",
                   help="device of the camera centres (--cameras); cuda unless the CPU is asked for")
    c.set_defaults(fn=cmd_create)
    m = sub.add_parser("merge")
    m.add_argument("--chunks", required=True)
    m.add_argument("--hier_name", default="hierarchy.hier")
    m.add_argument("--out", required=True)
    m.add_argument("--slack", type=float, default=0.5)
    m.set_defaults(fn=cmd_merge)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
