"""The per-slot interpolation of a LOD cut: its plain PyTorch version, the
CUDA kernels' launchers and the autograd Function around them.

`interpolate_cut` (hier/interp.py) picks each budget slot's child row `ri`
and parent row `pi` of the packed (P, 11 + 48) attribute matrix and hands
them here with the cut's `ts`, `kids` and `valid`:

  * `interpolate_plain`: the gathers and lerps in PyTorch ops, the CPU
    path and the kernels' reference;
  * csrc/interp.cu, `hidegs_interp_fwd`: the same outputs in one launch,
    reading the rows at `ri` and `pi` in place (no gathered copies);
  * csrc/interp.cu, `hidegs_interp_bwd`: the gradients at the child's and
    the parent's gathered rows, each (B, 59) matrix written once;
    `interp_plain_bwd` is the same arithmetic in PyTorch ops, held against
    autograd of `interpolate_plain` on the CPU;
  * `accumulate_rows`: their sums onto the P rows, PyTorch's sorted
    `index_put_` as autograd's backward of `attrs[ri]` or `attrs[pi]`
    runs it.

`InterpolateRows` is the Function over the two kernels and the sums. The
source builds with the package's other kernels (kernel_sources.py), is
loaded with ctypes and launched on PyTorch's current stream; each launcher
checks its inputs, raises on a failed launch and counts its launches. A
CPU tensor there raises; nothing falls back. This module imports nothing
of utils/graphs.py, which reads the counters.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from hidegs_tpu_torch import kernel_sources
from hidegs_tpu_torch.hier.lod import hierarchy_opacity_correction
from hidegs_tpu_torch.raster import cuda_blend
from hidegs_tpu_torch.train.losses import maximum

# Launches in this process, one per call of the launcher named beside it.
FWD_LAUNCHES = 0  # launch_interp_fwd
BWD_LAUNCHES = 0  # launch_interp_bwd

QUAT, OPAC, SH0 = 6, 10, 11  # pack_attributes' columns: means, scales, quats 6:10, opacity 10, SH 11:


def interpolate_plain(attrs, ri, pi, ts, kids, valid, sh_shape) -> Tuple[torch.Tensor, ...]:
    """(means (B, 3), scales (B, 3), quats (B, 4), opacity (B,), SH (B,
    *sh_shape)) of the B slots: each lerped from its child's row `ri` of
    `attrs` to its parent's row `pi` by t = `ts`, the rotation sign-aligned
    first, the opacity LOD-corrected by `kids`, 0 off `valid`."""
    t = ts[:, None]
    row_c = attrs[ri]
    row_p = attrs[pi]
    sh_dim = attrs.shape[1] - SH0

    m = t * row_c[:, 0:3] + (1 - t) * row_p[:, 0:3]
    s = t * row_c[:, 3:6] + (1 - t) * row_p[:, 3:6]
    sh = (t[..., None] * row_c[:, SH0:SH0 + sh_dim].reshape(-1, *sh_shape)
          + (1 - t[..., None]) * row_p[:, SH0:SH0 + sh_dim].reshape(-1, *sh_shape))

    rot_c = row_c[:, QUAT:OPAC]
    rot_p = row_p[:, QUAT:OPAC]
    dot = torch.sum(rot_c * rot_p, dim=-1, keepdim=True)
    sign = torch.where(dot < 0, -torch.ones_like(dot), torch.ones_like(dot))
    q = t * rot_c + (1 - t) * rot_p * sign

    op = ts * row_c[:, OPAC] + (1 - ts) * row_p[:, OPAC]
    op = hierarchy_opacity_correction(op, ts, kids)
    op = torch.where(valid, op, torch.zeros_like(op))
    return m, s, q, op, sh


def interp_plain_bwd(attrs, ri, pi, ts, kids, valid, g_means, g_scales, g_quats, g_opac, g_sh):
    """(grad_c, grad_p), each (B, W): the gradients at `attrs[ri]` and
    `attrs[pi]` of `interpolate_plain` for the gradients of its five
    outputs, written as autograd computes them and as csrc/interp.cu's
    backward does, op for op: a product passes g times the other factor,
    pow g·(e·w^(e − 1)), maximum half at a tie and none below the clamp,
    `where` none off the mask."""
    B = ri.shape[0]
    t = ts[:, None]
    omt = 1 - t
    row_c, row_p = attrs[ri], attrs[pi]
    rot_c, rot_p = row_c[:, QUAT:OPAC], row_p[:, QUAT:OPAC]
    dot = torch.sum(rot_c * rot_p, dim=-1, keepdim=True)
    sign = torch.where(dot < 0, -torch.ones_like(dot), torch.ones_like(dot))

    # the opacity: a = t·c + (1 − t)·p, w = max(1 − a, 1e-8), e = 1/max(kids, 1)
    omts = 1 - ts
    a = ts * row_c[:, OPAC] + omts * row_p[:, OPAC]
    e = torch.reciprocal(maximum(kids.to(torch.float32), 1.0))
    u = 1.0 - a
    floor = torch.full((), 1e-8, dtype=u.dtype, device=u.device)
    w = maximum(u, 1e-8)
    g = torch.where(valid, g_opac, torch.zeros_like(g_opac))
    g_pow = -(g * omts)
    g_w = torch.where(e == 0.0, torch.zeros_like(e), g_pow * (e * torch.pow(w, e - 1)))
    g_u = torch.where(u == floor, g_w / 2, g_w).masked_fill_(u < floor, 0)
    g_a = g * ts + -g_u

    grad_c = torch.cat([g_means * t, g_scales * t, g_quats * t, (g_a * ts)[:, None], g_sh.reshape(B, -1) * t], 1)
    grad_p = torch.cat([g_means * omt, g_scales * omt, g_quats * sign * omt, (g_a * omts)[:, None],
                        g_sh.reshape(B, -1) * omt], 1)
    # autograd sums a gathered row's gradient over its five column slices,
    # each zero outside its columns, which makes a -0 +0
    return grad_c + 0.0, grad_p + 0.0


def accumulate_rows(attrs, idx, grad) -> torch.Tensor:
    """The (P, W) gradient of `attrs` from the gradient `grad` of
    `attrs[idx]`, as autograd's backward of the gather computes it:
    `_index_put_impl_` with accumulate into zeros (on a card a sort that
    sums the rows sharing an index in a fixed order), unsafe as autograd
    calls it (the range check would read the indices' extremes to the
    host, which a graph capture refuses)."""
    return torch.ops.aten._index_put_impl_(attrs.new_zeros(attrs.shape), [idx], grad, True, True)


@functools.cache
def _fn(symbol: str, n_ptr_head: int, n_ptr_tail: int):
    return cuda_blend.bind(cuda_blend.build(kernel_sources.SOURCES)["interp"], symbol, n_ptr_head, 2, 0, n_ptr_tail)


def _check_slots(attrs, ri, pi, ts, kids, valid) -> Tuple[int, int]:
    """(B, W) after checking what both kernels read: a float32 contiguous
    (P, W) matrix with SH columns and fewer than 256 of them, and the B
    slots' int64 rows, float32 `ts`, int32 `kids` and bool `valid`. The
    rows must lie in [0, P) (`interp.slot_rows` makes them so); they are
    not read back to check, which would wait on the device."""
    dev = attrs.device
    if dev.type != "cuda":
        raise ValueError(f"the interpolation kernels need CUDA tensors, got {dev}")
    if attrs.ndim != 2 or not SH0 < attrs.shape[1] < 256:
        raise ValueError(f"attrs has shape {tuple(attrs.shape)}, expected (P, W) with {SH0} < W < 256")
    cuda_blend._check("attrs", attrs, torch.float32, attrs.shape, dev)
    B = ri.shape[0] if ri.ndim else -1
    cuda_blend._check("ri", ri, torch.int64, (B,), dev)
    cuda_blend._check("pi", pi, torch.int64, (B,), dev)
    cuda_blend._check("ts", ts, torch.float32, (B,), dev)
    cuda_blend._check("kids", kids, torch.int32, (B,), dev)
    cuda_blend._check("valid", valid, torch.bool, (B,), dev)
    return B, attrs.shape[1]


def _shapes(B: int, W: int):
    return dict(means=(B, 3), scales=(B, 3), quats=(B, 4), opacity=(B,), sh=(B, W - SH0))


def _check_rows(name, x, shape, dev) -> None:
    """A contiguous float32 `x` of `shape` once its trailing dims are
    flattened (the SH's (B, 16, 3) as (B, 48))."""
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    cuda_blend._check(name, x.flatten(1) if x.ndim > 2 else x, torch.float32, shape, dev)


def launch_interp_fwd(attrs, ri, pi, ts, kids, valid, out) -> None:
    """Launch the forward kernel once on the current stream, writing the
    five tensors of `out` (means, scales, quats, opacity, SH: `_shapes`)."""
    global FWD_LAUNCHES
    B, W = _check_slots(attrs, ri, pi, ts, kids, valid)
    for x, (name, shape) in zip(out, _shapes(B, W).items(), strict=True):
        _check_rows(name, x, shape, attrs.device)
    fn = _fn("hidegs_interp_fwd", 6, 6)
    with torch.cuda.device(attrs.device):
        rc = fn(attrs.data_ptr(), ri.data_ptr(), pi.data_ptr(), ts.data_ptr(), kids.data_ptr(), valid.data_ptr(),
                B, W, *(x.data_ptr() for x in out), cuda_blend._stream(attrs.device))
    FWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"interp_fwd kernel launch failed: cudaError {rc}")


def launch_interp_bwd(attrs, ri, pi, ts, kids, valid, grads, grad_c, grad_p) -> None:
    """Launch the backward kernel once on the current stream: `grads` are
    the gradients of the forward's five outputs, shaped as they are;
    writes `grad_c` and `grad_p`, (B, W) each."""
    global BWD_LAUNCHES
    B, W = _check_slots(attrs, ri, pi, ts, kids, valid)
    for g, (name, shape) in zip(grads, _shapes(B, W).items(), strict=True):
        _check_rows(f"the gradient of {name}", g, shape, attrs.device)
    cuda_blend._check("grad_c", grad_c, torch.float32, (B, W), attrs.device)
    cuda_blend._check("grad_p", grad_p, torch.float32, (B, W), attrs.device)
    fn = _fn("hidegs_interp_bwd", 11, 3)
    with torch.cuda.device(attrs.device):
        rc = fn(attrs.data_ptr(), ri.data_ptr(), pi.data_ptr(), ts.data_ptr(), kids.data_ptr(), valid.data_ptr(),
                *(g.data_ptr() for g in grads), B, W, grad_c.data_ptr(), grad_p.data_ptr(),
                cuda_blend._stream(attrs.device))
    BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"interp_bwd kernel launch failed: cudaError {rc}")


class InterpolateRows(torch.autograd.Function):
    """(attrs, ri, pi, ts, kids, valid, sh_shape) → `interpolate_plain`'s
    five outputs, forward on one launch of the forward kernel; backward one
    launch of the backward kernel, then `accumulate_rows` of each gather,
    summed. Only `attrs` is differentiable; absent output gradients are
    zeros."""

    @staticmethod
    def forward(ctx, attrs, ri, pi, ts, kids, valid, sh_shape):
        B = ri.shape[0]
        out = tuple(torch.empty(shape, dtype=torch.float32, device=attrs.device)
                    for shape in ((B, 3), (B, 3), (B, 4), (B,), (B, *sh_shape)))
        launch_interp_fwd(attrs, ri, pi, ts, kids, valid, out)
        ctx.save_for_backward(attrs, ri, pi, ts, kids, valid)
        return out

    @staticmethod
    def backward(ctx, *grads):
        attrs, ri, pi, ts, kids, valid = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        grad_c = torch.empty((ri.shape[0], attrs.shape[1]), dtype=torch.float32, device=attrs.device)
        grad_p = torch.empty_like(grad_c)
        launch_interp_bwd(attrs, ri, pi, ts, kids, valid, [g.contiguous() for g in grads], grad_c, grad_p)
        # the two gathers' sums, added as autograd adds them; the child's
        # rows freed before the parents' sum, which bounds the step's peak
        rows = accumulate_rows(attrs, ri, grad_c)
        del grad_c
        return (rows.add_(accumulate_rows(attrs, pi, grad_p)),) + (None,) * 6
