"""LPIPS weight conversion in the port (train/lpips.py:
params_from_torch_modules, convert_torch_weights, main) against the JAX
package's: the same parameter dict from the same torch modules, the same
distance from it in both packages (1e-5, the serving tests' LPIPS
tolerance), and the branches that need no weights. Nothing is downloaded:
the modules are built here from a seed, and the branches that would load
pretrained weights are driven only where their package is missing."""
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.train import lpips as jlpips
from hidegs_tpu_torch.train import lpips as tlpips

torch.set_num_threads(1)


def _vgg_convs(seed=0):
    torch.manual_seed(seed)
    convs, in_ch = [], 3
    for ch, n in tlpips.VGG16_BLOCKS:
        for _ in range(n):
            convs.append(torch.nn.Conv2d(in_ch, ch, 3, padding=1))
            in_ch = ch
    return convs


@pytest.mark.parametrize("heads", [False, True])
def test_params_from_torch_modules_match_jax(heads):
    convs = _vgg_convs()
    rng = np.random.default_rng(1)
    lins = [rng.uniform(0, 1, (1, ch, 1, 1)).astype(np.float32) for ch, _ in tlpips.VGG16_BLOCKS] if heads else None
    got = tlpips.params_from_torch_modules(convs, lins)
    want = jlpips.params_from_torch_modules(convs, lins)
    assert got.keys() == want.keys() and len(got) == 13 * 2 + 5
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_converted_params_give_the_jax_distance():
    convs = _vgg_convs(2)
    arrays = tlpips.params_from_torch_modules(convs)
    params = tlpips.params_to_device(arrays, "cpu")
    jparams = {k: jnp.asarray(v) for k, v in jlpips.params_from_torch_modules(convs).items()}
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(0, 1, (3, 32, 40)).astype(np.float32) for _ in range(2))
    got = float(tlpips.lpips_distance(params, torch.tensor(a), torch.tensor(b)))
    want = float(jlpips.lpips_distance(jparams, jnp.asarray(a), jnp.asarray(b)))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_from_torch_modules_checks_the_conv_count():
    with pytest.raises(ValueError, match="expected 13 convs"):
        tlpips.params_from_torch_modules(_vgg_convs()[:12])


@pytest.mark.parametrize("source,module", [("lpips", "lpips"), ("torchvision", "torchvision")])
def test_convert_torch_weights_without_its_package(tmp_path, monkeypatch, source, module):
    """A missing package raises ImportError and writes nothing (forced
    missing, so the test does not depend on what is installed)."""
    monkeypatch.setitem(sys.modules, module, None)
    out = tmp_path / "w.npz"
    with pytest.raises(ImportError):
        tlpips.convert_torch_weights(str(out), source)
    assert not out.exists()


@pytest.mark.parametrize("source", ["lpips", "torchvision"])
def test_convert_torch_weights_fetches_nothing(tmp_path, monkeypatch, source):
    """With the packages present (stand-ins here) but torchvision's VGG16
    weights missing from torch.hub's cache, the conversion raises
    FileNotFoundError naming the file, and builds no network (which would
    fetch them)."""
    built = []

    class Weights:
        class IMAGENET1K_V1:
            url = "https://download.example/models/vgg16-397923af.pth"

    models = types.ModuleType("torchvision.models")
    models.VGG16_Weights = Weights
    models.vgg16 = lambda **kw: built.append(("vgg16", kw))
    vision = types.ModuleType("torchvision")
    vision.models = models
    lp = types.ModuleType("lpips")
    lp.LPIPS = lambda **kw: built.append(("LPIPS", kw))
    monkeypatch.setitem(sys.modules, "torchvision", vision)
    monkeypatch.setitem(sys.modules, "torchvision.models", models)
    monkeypatch.setitem(sys.modules, "lpips", lp)
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    out = tmp_path / "w.npz"
    with pytest.raises(FileNotFoundError, match="vgg16-397923af.pth"):
        tlpips.convert_torch_weights(str(out), source)
    assert built == [] and not out.exists()


def test_convert_torch_weights_rejects_an_unknown_source(tmp_path):
    with pytest.raises(ValueError, match="unknown source"):
        tlpips.convert_torch_weights(str(tmp_path / "w.npz"), "caffe")


def test_main_help(capsys):
    with pytest.raises(SystemExit) as e:
        tlpips.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--out" in out and "--source" in out and "calibrated" in out
