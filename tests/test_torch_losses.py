"""Port parity of the loss stack: hidegs_tpu_torch.train.{losses, frequency,
geometric} against hidegs_tpu.train.*, values and gradients.

Tolerance: 1e-5, relative for values and, for gradients, absolute after
normalising by the max |grad| (float32 convolutions, FFTs and reductions in
another order). The images carry exact zeros (background) and exact ones,
so the clips of the loss stack sit on their bounds: jnp.clip, jnp.maximum
and jnp.minimum give half the gradient to each side there, and so must the
port (torch.clamp would give all of it to the input).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.train import frequency as jfreq
from hidegs_tpu.train import geometric as jgeo
from hidegs_tpu.train import losses as jloss
from hidegs_tpu_torch.train import frequency as tfreq
from hidegs_tpu_torch.train import geometric as tgeo
from hidegs_tpu_torch.train import losses as tloss

torch.set_num_threads(1)

TOL = 1e-5
H, W = 40, 52


def _image(seed, zero_frac=0.3):
    """(3, H, W) in [0, 1] with a block of exact zeros (background) and a
    block of exact ones."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    img = img * (rng.uniform(0, 1, (1, H, W)) > 0.2)  # scattered zeros
    img[:, : int(H * zero_frac), : W // 2] = 0.0
    img[:, -6:, -8:] = 1.0
    return img


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * (np.abs(want).max() + 1e-12), err_msg=what)


def _value_and_grads(jfn, tfn, arrays, argnums):
    """Value and gradients (w.r.t. `argnums`) of the same function in both
    packages on the same numpy inputs."""
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a), argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    leaves = [torch.tensor(a).requires_grad_(i in argnums and a.dtype == np.float32)
              for i, a in enumerate(arrays)]
    tv = tfn(*leaves)
    tg = torch.autograd.grad(tv, [leaves[i] for i in argnums])
    return (jv, jg), (tv, tg)


def _check(jfn, tfn, arrays, argnums=(0,), what=""):
    (jv, jg), (tv, tg) = _value_and_grads(jfn, tfn, arrays, argnums)
    _close(tv, jv, f"{what} value")
    for i, (a, b) in enumerate(zip(tg, jg)):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all(), f"{what} grad {i}"
        denom = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / denom, b / denom, atol=TOL, err_msg=f"{what} grad {i}")


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "psnr", "ssim", "dssim_l1"])
def test_photometric_losses_match_jax(name):
    # both images are 0 on a common block: |pred - gt| at 0, and flat
    # windows whose variance clamps sit on their bound
    pred, gt = _image(0), _image(1, zero_frac=0.5)
    _check(getattr(jloss, name), getattr(tloss, name), [pred, gt], argnums=(0,), what=name)


def test_psnr_masked_matches_jax():
    pred, gt = _image(2), _image(3)
    mask = (np.random.default_rng(4).uniform(0, 1, (H, W)) > 0.3).astype(np.float32)
    _close(tloss.psnr(torch.tensor(pred), torch.tensor(gt), torch.tensor(mask)),
           jloss.psnr(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)), "masked psnr")


def test_clip_and_abs_gradients_at_ties_match_jax():
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    w = np.arange(1.0, 6.0, dtype=np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0) * w))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (tloss.clip(t, 0.0, 1.0) * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(t.grad.numpy(), [0.0, 1.0, 3.0, 2.0, 0.0])  # half at the ties
    jg = jax.grad(lambda a: jnp.sum(jnp.abs(a) * w))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (tloss.abs_(t) * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(t.grad.numpy(), [-1.0, 2.0, 3.0, 4.0, 5.0])  # +1 at 0


def test_image_helpers_match_jax():
    gt = _image(5)
    _close(tloss.image_gradient_weight(torch.tensor(gt)), jloss.image_gradient_weight(jnp.asarray(gt)), "edge weight")
    mask = (np.random.default_rng(6).uniform(0, 1, (H, W)) > 0.8).astype(np.float32)
    for it in (1, 2):
        _close(tloss.dilate(torch.tensor(mask), it), jloss.dilate(jnp.asarray(mask), it), f"dilate {it}")
        _close(tloss.erode(torch.tensor(mask), it), jloss.erode(jnp.asarray(mask), it), f"erode {it}")
    rng = np.random.default_rng(7)
    ref = rng.uniform(0, 1, (64, 9)).astype(np.float32)
    src = (ref + rng.normal(0, 0.3, ref.shape)).astype(np.float32)
    src[:4] = ref[:4]  # NCC exactly 1: on the clip bound
    _check(lambda a, b: jnp.sum(jloss.lncc(a, b)[0]), lambda a, b: torch.sum(tloss.lncc(a, b)[0]),
           [ref, src], argnums=(0, 1), what="lncc")
    np.testing.assert_array_equal(tloss.lncc(torch.tensor(ref), torch.tensor(src))[1].numpy(),
                                  np.asarray(jloss.lncc(jnp.asarray(ref), jnp.asarray(src))[1]))


@pytest.mark.parametrize("name", ["_spatial_freq_loss", "_fft_freq_loss"])
def test_frequency_terms_match_jax(name):
    r, g = _image(8).mean(0), _image(9).mean(0)
    _check(getattr(jfreq, name), getattr(tfreq, name), [r, g], argnums=(0,), what=name)


def test_pyramid_and_mask_match_jax():
    r, g = _image(10), _image(11)
    _check(jfreq.frequency_pyramid_loss, tfreq.frequency_pyramid_loss, [r, g], argnums=(0,), what="pyramid")
    _close(tfreq.high_frequency_mask(torch.tensor(g)), jfreq.high_frequency_mask(jnp.asarray(g)), "hf mask")


def test_scale_regularization_matches_jax_with_tied_scales():
    rng = np.random.default_rng(12)
    scales = rng.uniform(0.0, 0.2, (64, 3)).astype(np.float32)
    scales[:16] = scales[:16, :1]  # isotropic rows: the max ties three ways
    visible = rng.uniform(0, 1, 64) > 0.3
    _check(lambda s: jfreq.scale_regularization(s, jnp.asarray(visible)),
           lambda s: tfreq.scale_regularization(s, torch.tensor(visible)),
           [scales], what="scale reg")


@pytest.mark.parametrize("iteration", [0, 2000])
def test_frequency_regularization_matches_jax(iteration):
    r, g = _image(13), _image(14)
    rng = np.random.default_rng(15)
    scales = rng.uniform(0.0, 0.05, (80, 3)).astype(np.float32)
    visible = rng.uniform(0, 1, 80) > 0.2

    def jf(a, s):
        return jfreq.frequency_regularization(a, jnp.asarray(g), s, jnp.asarray(visible), iteration,
                                              lambda_freq=0.3, lambda_scale=5.0)[0]

    def tf(a, s):
        return tfreq.frequency_regularization(a, torch.tensor(g), s, torch.tensor(visible), iteration,
                                              lambda_freq=0.3, lambda_scale=5.0)[0]

    _check(jf, tf, [r, scales], argnums=(0, 1), what=f"frequency regularization at {iteration}")


def test_single_view_normal_loss_matches_jax():
    rng = np.random.default_rng(16)
    nr = rng.normal(size=(3, H, W)).astype(np.float32)
    nd = rng.normal(size=(3, H, W)).astype(np.float32)
    alpha = rng.uniform(0, 1.2, (H, W)).astype(np.float32)
    alpha[:10] = 0.0  # background: alpha on clip's lower bound
    alpha[-3:] = 1.0
    nr[:, :10] = 0.0
    nd[:, :10] = 0.0  # and both normals zero there: |0 - 0|
    gt = _image(17)
    _check(lambda a, b, c: jgeo.single_view_normal_loss(a, b, jnp.asarray(gt), c),
           lambda a, b, c: tgeo.single_view_normal_loss(a, b, torch.tensor(gt), c),
           [nr, nd, alpha], argnums=(0, 1, 2), what="single view")
