"""The LOD cut's interpolation kernels (hier/csrc/interp.cu) against the
plain expression, on a card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor the JAX package:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_interp_cuda.py

`interpolate_cut` on CUDA tensors runs `InterpolateRows` (the two kernels
and PyTorch's sorted accumulation); the plain side is the same call with
`interpolate_plain` in its place, on the same card. Cuts with padding slots,
t = 1 and t < 1, negative child-parent rotation dots, kids of 1 and more,
opacity columns on both sides of the 1e-8 clamp (its tie cannot be formed
in float32: tests/test_torch_interp.py), a skybox tail, and 2P-row arrays
whose parent half is detached, as the post-opt check's `no_parent_grad`
fault passes them. The forward outputs and the gradients into the five
activated arrays are bitwise the plain path's, the opacity included: the
kernels' powf, built with the package's flags, rounds as torch.pow's does
(on an H100 with torch 2.11 and CUDA 12.8; a toolkit that rounds apart
fails here first).
"""
import numpy as np
import pytest
import torch
from test_torch_interp import _cut, bits, out_grads, slots_problem

from hidegs_tpu_torch.hier import interp
from hidegs_tpu_torch.hier import interp_autograd as ia

CASES = ("padding", "skybox", "doubled")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


class PlainRows:
    """InterpolateRows' stand-in: the plain expression."""

    apply = staticmethod(ia.interpolate_plain)


def arrays_problem(dev, P=900, seed=0):
    """Five activated arrays of P gaussians with the opacities at and
    around the clamp and, in rows 0 and 1, a child and parent rotation
    whose dot cancels: its sign hangs on torch.sum's order."""
    g = torch.Generator().manual_seed(seed)
    quats = torch.randn(P, 4, generator=g)
    quats[0] = torch.tensor([1.0, 1.0, 1.0, 1.0])
    quats[1] = torch.tensor([1.0, -2.0 ** -25, -1.0, 2.0 ** -26])
    opac = torch.rand(P, generator=g)
    opac[2:40] = 1.0
    opac[40:80] = 1 - 2.0 ** -24
    opac[80:90] = 1.5
    arrays = (torch.randn(P, 3, generator=g), torch.rand(P, 3, generator=g) + 0.05, quats, opac,
              torch.randn(P, 16, 3, generator=g))
    return [a.to(dev) for a in arrays]


def cut_problem(dev, P, B=5000):
    cut = _cut(B, P)
    cut = cut._replace(render_indices=cut.render_indices.clone(), parent_indices=cut.parent_indices.clone(),
                       ts=cut.ts.clone(), kids=cut.kids.clone(), valid=cut.valid.clone())
    cut.valid[:4] = True
    cut.render_indices[:4] = torch.tensor([0, 1, 2, 40], dtype=torch.int32)
    cut.parent_indices[:4] = torch.tensor([1, 0, 41, 3], dtype=torch.int32)
    cut.ts[:4] = torch.tensor([0.25, 0.5, 0.75, 0.5])
    cut.kids[:4] = torch.tensor([1, 3, 2, 7], dtype=torch.int32)
    return type(cut)(*(x.to(dev) for x in cut))


def case_inputs(dev, case):
    """(cut, arrays, skybox_count) of a case (`run` doubles the rows of
    "doubled")."""
    arrays = arrays_problem(dev)
    P = arrays[0].shape[0]
    cut = cut_problem(dev, P)
    sky = 16 if case == "skybox" else 0
    return cut, arrays, sky


def run(case_cut, arrays, sky, case, plain, monkeypatch, g_seed=1):
    """interpolate_cut on the card, kernels or plain, and the gradients of
    Σ out·g into the five arrays. "doubled" hands it 2P rows whose second
    half is the first detached, the valid slots' parents there."""
    leaves = [a.clone().requires_grad_(True) for a in arrays]
    cut, inputs = case_cut, leaves
    if case == "doubled":
        P = leaves[0].shape[0]
        inputs = [torch.cat([a, a.detach()]) for a in leaves]
        cut = cut._replace(parent_indices=torch.where(cut.valid, cut.parent_indices + P, cut.parent_indices))
    with monkeypatch.context() as m:
        if plain:
            m.setattr(interp, "InterpolateRows", PlainRows)
        outs = interp.interpolate_cut(cut, *inputs, skybox_count=sky)
    grads = out_grads([o.cpu() for o in outs], g_seed)
    torch.autograd.backward(outs, [x.to(outs[0].device) for x in grads])
    return [o.detach() for o in outs], [x.grad for x in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernels_are_the_plain_expression(cuda, case, monkeypatch):
    """Forward outputs and the gradients into the five arrays, kernels
    against the plain expression on the card: bitwise; each call launches
    each kernel once."""
    cut, arrays, sky = case_inputs(cuda, case)
    counts = (ia.FWD_LAUNCHES, ia.BWD_LAUNCHES)
    outs, grads = run(cut, arrays, sky, case, False, monkeypatch)
    torch.cuda.synchronize()
    assert (ia.FWD_LAUNCHES, ia.BWD_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    want_outs, want_grads = run(cut, arrays, sky, case, True, monkeypatch)
    assert (ia.FWD_LAUNCHES, ia.BWD_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    names = ("means3d", "scales", "quats", "opacities", "shs")
    for what, got, want in (("output", outs, want_outs), ("gradient", grads, want_grads)):
        for name, a, b in zip(names, got, want, strict=True):
            assert a.shape == b.shape and torch.equal(bits(a), bits(b)), f"{case}: {what} {name}"
    if case == "doubled":
        assert float(grads[0].abs().sum()) > 0


@pytest.mark.cuda
def test_the_rotation_sign_takes_torch_sums_order(cuda, monkeypatch):
    """Slot 0 interpolates row 0 ([1, 1, 1, 1]) toward row 1 ([1, -2^-25,
    -1, 2^-26]): the products' sum is negative as (x0 + x2) + (x1 + x3)
    and zero as (x0 + x1) + (x2 + x3), so the quaternion the kernel writes
    holds only if it sums in torch.sum's order on this card."""
    x = np.float32([1.0, -2.0 ** -25, -1.0, 2.0 ** -26])
    assert ((x[0] + x[2]) + (x[1] + x[3]) < 0) != ((x[0] + x[1]) + (x[2] + x[3]) < 0)
    cut, arrays, _ = case_inputs(cuda, "padding")
    rows = (arrays[2][0] * arrays[2][1]).sum()
    outs, _ = run(cut, arrays, 0, "padding", False, monkeypatch)
    want, _ = run(cut, arrays, 0, "padding", True, monkeypatch)
    assert torch.equal(bits(outs[2][0]), bits(want[2][0])), (float(rows), outs[2][0], want[2][0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "interpolating"])
def test_backward_kernel_is_the_plain_backward_at_the_rows(cuda, case):
    """The backward kernel's two (B, W) matrices against interp_plain_bwd
    on the card (the CPU tests hold that against autograd), and the
    forward kernel's outputs against interpolate_plain: bitwise."""
    attrs, ri, pi, ts, kids, valid, sh_shape = (x.to(cuda) if isinstance(x, torch.Tensor) else x
                                                for x in slots_problem(case))
    B, W = ri.shape[0], attrs.shape[1]
    want = ia.interpolate_plain(attrs, ri, pi, ts, kids, valid, sh_shape)
    out = [torch.empty_like(x) for x in want]
    ia.launch_interp_fwd(attrs, ri, pi, ts, kids, valid, out)
    grads = [x.to(cuda) for x in out_grads([w.cpu() for w in want])]
    grad_c, grad_p = torch.empty(B, W, device=cuda), torch.empty(B, W, device=cuda)
    ia.launch_interp_bwd(attrs, ri, pi, ts, kids, valid, grads, grad_c, grad_p)
    want_c, want_p = ia.interp_plain_bwd(attrs, ri, pi, ts, kids, valid, *grads)
    for name, a, b in zip(("means", "scales", "quats", "opacity", "sh"), out, want, strict=True):
        assert torch.equal(bits(a), bits(b)), name
    assert torch.equal(bits(grad_c), bits(want_c)) and torch.equal(bits(grad_p), bits(want_p))


@pytest.mark.cuda
def test_a_captured_interpolation_replays_the_eager_one_bitwise(cuda, monkeypatch):
    """interpolate_cut and its backward captured as one CUDA graph
    (utils/graphs.py:GraphSet.capture): one launch of each kernel recorded
    and none of the others; each replay, the cut's weights and the arrays
    changed in place between them, bitwise the eager call on the same
    inputs, and adds one launch of each to REPLAY_LAUNCHES."""
    from hidegs_tpu_torch.utils import graphs

    cut, arrays, sky = case_inputs(cuda, "skybox")
    leaves = [a.clone().requires_grad_(True) for a in arrays]
    gouts = [x.to(cuda) for x in out_grads([o.cpu() for o in interp.interpolate_cut(cut, *arrays,
                                                                                     skybox_count=sky)])]

    def body():
        outs = interp.interpolate_cut(cut, *leaves, skybox_count=sky)
        return [o.detach() for o in outs], list(torch.autograd.grad(outs, leaves, gouts))

    gs = graphs.GraphSet("interpolation")
    g = gs.capture(cuda, body, body, {})
    assert g.launches == dict(dict.fromkeys(graphs.ALL_KERNELS, 0), interp_fwd=1, interp_bwd=1)
    for k in range(2):
        with torch.no_grad():
            for x in leaves:
                x.mul_(0.875)
            cut.ts.mul_(0.75)
        before = dict(graphs.REPLAY_LAUNCHES)
        gs.replay(g)
        torch.cuda.synchronize()
        assert graphs.REPLAY_LAUNCHES["interp_fwd"] == before["interp_fwd"] + 1
        assert graphs.REPLAY_LAUNCHES["interp_bwd"] == before["interp_bwd"] + 1
        outs, grads = body()
        for n, (a, b) in enumerate(zip((*g.outputs[0], *g.outputs[1]), (*outs, *grads))):
            assert torch.equal(a, b), f"replay {k}: tensor {n}"
