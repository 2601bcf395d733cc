"""The LOD cut's interpolation on the CPU (hier/interp_autograd.py).

  * `interp_plain_bwd`, the plain version of csrc/interp.cu's backward,
    against autograd of `interpolate_plain` at the two gathered matrices
    (`attrs[ri]`, `attrs[pi]`, read by a pre-hook on their backward nodes):
    bitwise, -0 and +0 told apart;
  * the sum of `accumulate_rows` of those rows against autograd's
    gradient of the packed matrix: bitwise at one thread (PyTorch's CPU
    `index_put_` accumulates in parallel with more);
  * `interpolate_cut` on CPU tensors is the plain expression and launches
    nothing; the kernels' launchers and the Function refuse CPU tensors.

The kernels themselves are held against the plain versions on a card by
tests/test_torch_interp_cuda.py.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from hidegs_tpu_torch.hier import interp
from hidegs_tpu_torch.hier import interp_autograd as ia
from hidegs_tpu_torch.hier.lod import HierCut

CASES = ("mixed", "interpolating", "sh_degree_1")


def slots_problem(case: str, B: int = 3000, P: int = 701, seed: int = 0):
    """(attrs, ri, pi, ts, kids, valid, sh_shape) of B slots over P rows.
    "mixed": a fifth of the slots padding, t = 1 on a third and t = 0 on a
    seventh, kids 1 to 8, random rotations (about half the child-parent
    dots negative), and opacity columns at 1 (below the 1e-8 clamp once
    subtracted from 1), 1 - 2^-24 (just above it), 1.5 and in [0, 1).
    "interpolating": every slot valid with 0 < t < 1. "sh_degree_1": as
    mixed with 4 SH coefficients a row (W = 23)."""
    g = torch.Generator().manual_seed(seed)
    sh_shape = (4, 3) if case == "sh_degree_1" else (16, 3)
    attrs = torch.randn(P, ia.SH0 + sh_shape[0] * sh_shape[1], generator=g)
    attrs[:, ia.OPAC] = torch.rand(P, generator=g)
    attrs[:40, ia.OPAC] = 1.0
    attrs[40:80, ia.OPAC] = 1 - 2.0 ** -24
    attrs[80:90, ia.OPAC] = 1.5
    ri = torch.randint(0, P, (B,), generator=g)
    pi = torch.randint(0, P, (B,), generator=g)
    ts = torch.rand(B, generator=g)
    kids = torch.randint(1, 9, (B,), generator=g, dtype=torch.int32)
    valid = torch.rand(B, generator=g) > 0.2
    if case == "interpolating":
        ts = ts.clamp(1e-3, 1 - 1e-3)
        valid[:] = True
    else:
        ts[::3] = 1.0
        ts[1::7] = 0.0
        kids[::5] = 1
    return attrs, ri, pi, ts, kids, valid, sh_shape


def gathered_grads(outs, grads, ri):
    """autograd's gradients at `attrs[ri]` and at `attrs[pi]` for `grads`
    of `outs`: what each gather's backward node receives."""
    nodes, seen, stack = [], set(), [o.grad_fn for o in outs]
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        if type(n).__name__ == "IndexBackward0":
            nodes.append(n)
        stack.extend(f for f, _ in n.next_functions)
    assert len(nodes) == 2
    child = [n for n in nodes if torch.equal(n._saved_indices[0], ri)]
    assert len(child) == 1
    got = {}
    for n in nodes:
        n.register_prehook(lambda go, n=n: got.__setitem__(n is child[0], go[0].clone()))
    torch.autograd.backward(outs, grads)
    return got[True], got[False]


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def out_grads(outs, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g) for o in outs]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_is_autograd_at_the_gathered_rows(case):
    attrs, ri, pi, ts, kids, valid, sh_shape = slots_problem(case)
    outs = ia.interpolate_plain(attrs.clone().requires_grad_(True), ri, pi, ts, kids, valid, sh_shape)
    grads = out_grads(outs)
    want_c, want_p = gathered_grads(outs, grads, ri)
    got_c, got_p = ia.interp_plain_bwd(attrs, ri, pi, ts, kids, valid, *grads)
    assert torch.equal(bits(got_c), bits(want_c)) and torch.equal(bits(got_p), bits(want_p))
    if case != "interpolating":
        # the +0 the backward adds matters: t = 0 makes -0 products
        assert bool((bits(grads[0] * ts[:, None]) == -2 ** 31).any())


@pytest.mark.parametrize("case", CASES)
def test_rows_gradient_is_autograd_of_the_gathers(case):
    attrs, ri, pi, ts, kids, valid, sh_shape = slots_problem(case)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        leaf = attrs.clone().requires_grad_(True)
        outs = ia.interpolate_plain(leaf, ri, pi, ts, kids, valid, sh_shape)
        grads = out_grads(outs)
        torch.autograd.backward(outs, grads)
        grad_c, grad_p = ia.interp_plain_bwd(attrs, ri, pi, ts, kids, valid, *grads)
        rows = ia.accumulate_rows(attrs, ri, grad_c) + ia.accumulate_rows(attrs, pi, grad_p)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(bits(rows), bits(leaf.grad))


def test_the_opacity_clamp_tie_cannot_be_formed_in_float32():
    """1 − a is exact for a in [0.5, 2] (Sterbenz), a multiple of 2^-24
    below 1, and at least 0.5 or below −1 elsewhere: it never equals
    float32(1e-8), so maximum's tie in the opacity correction is out of
    reach and the card tests cover the clamp from both sides instead."""
    floor = np.float32(1e-8)
    a = np.nextafter(np.float32(1), np.float32(0)) - np.arange(1 << 16, dtype=np.float32) * np.float32(2.0 ** -24)
    a = np.concatenate([a, np.float32([1.0, 0.5, 2.0])])
    u = np.float32(1) - a
    assert not (u == floor).any() and (u < floor).sum() == 2  # a = 1 and a = 2
    assert np.float32(2.0 ** -24) > floor


def _cut(B, P, seed=3):
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand(B, generator=g) > 0.25
    return HierCut(
        render_indices=torch.where(valid, torch.randint(0, P, (B,), generator=g), P).to(torch.int32),
        parent_indices=torch.randint(0, P, (B,), generator=g).to(torch.int32),
        node_of=torch.zeros(B, dtype=torch.int32),
        ts=torch.where(valid & (torch.rand(B, generator=g) < 0.5), torch.rand(B, generator=g), 1.0),
        kids=torch.where(valid, torch.randint(1, 6, (B,), generator=g), 1).to(torch.int32),
        valid=valid,
        num_selected=valid.sum().to(torch.int32),
    )


def test_cpu_interpolate_cut_is_the_plain_expression_and_launches_nothing():
    P, B, sky = 300, 1000, 7
    g = torch.Generator().manual_seed(4)
    arrays = (torch.randn(P, 3, generator=g), torch.rand(P, 3, generator=g) + 0.1,
              torch.nn.functional.normalize(torch.randn(P, 4, generator=g), dim=-1), torch.rand(P, generator=g),
              torch.randn(P, 16, 3, generator=g))
    cut = _cut(B, P)
    counts = (ia.FWD_LAUNCHES, ia.BWD_LAUNCHES)
    got = interp.interpolate_cut(cut, *arrays, skybox_count=sky)
    ri, pi = interp.slot_rows(cut, P)
    assert bool((ri[~cut.valid] == torch.arange(B)[~cut.valid] % P).all())
    want = ia.interpolate_plain(interp.pack_attributes(*arrays), ri, pi, cut.ts, cut.kids, cut.valid, (16, 3))
    for x, y, a in zip(got, want, arrays):
        assert x.shape[0] == B + sky and torch.equal(x[:B], y) and torch.equal(x[B:], a[P - sky:])
    assert (ia.FWD_LAUNCHES, ia.BWD_LAUNCHES) == counts


def test_the_kernels_refuse_cpu_tensors():
    attrs, ri, pi, ts, kids, valid, sh_shape = slots_problem("mixed", B=8, P=5)
    out = [torch.empty(s) for s in ((8, 3), (8, 3), (8, 4), (8,), (8, 16, 3))]
    with pytest.raises(ValueError, match="CUDA"):
        ia.launch_interp_fwd(attrs, ri, pi, ts, kids, valid, out)
    with pytest.raises(ValueError, match="CUDA"):
        ia.launch_interp_bwd(attrs, ri, pi, ts, kids, valid, out, torch.empty(8, 59), torch.empty(8, 59))
    with pytest.raises(ValueError, match="CUDA"):
        ia.InterpolateRows.apply(attrs, ri, pi, ts, kids, valid, sh_shape)


def test_the_kernels_are_listed_counted_and_named_apart():
    """csrc/interp.cu sits under hier/csrc in the one list of sources and
    uses no atomics; its kernels' names hold neither
    `indexing_backward_kernel` (the accumulation the post-opt trace times)
    nor `blend_bwd`, which the benchmark's trace matches by substring; its
    counters are in utils/graphs.py:ALL_KERNELS and not in KERNELS, which
    the benchmark pairs with the five render counters."""
    from hidegs_tpu_torch import kernel_sources
    from hidegs_tpu_torch.utils import graphs

    src = kernel_sources.SOURCES["interp"]
    assert src.parent == pathlib.Path(interp.__file__).parent / "csrc"
    text = src.read_text()
    assert not re.search(r"atomic\w*\s*\(", text)
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", text)
    assert names == ["interp_fwd_kernel", "interp_bwd_kernel"]
    assert not any("indexing_backward_kernel" in n or "blend_bwd" in n for n in names)
    assert graphs.ALL_KERNELS[-2:] == ("interp_fwd", "interp_bwd") and "interp_fwd" not in graphs.KERNELS
    graphs._set_kernel_counts(graphs._kernel_counts())  # the counters round-trip
    assert len(graphs._kernel_counts()) == len(graphs.ALL_KERNELS)
