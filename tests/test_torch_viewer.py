"""The port's viewers (viewer/network_gui.py, viewer/http_viewer.py and
`python -m hidegs_tpu_torch.viewer`) on the CPU: the socket round trips of
tests/test_viewer.py on the port, the pose of a request decoded as the JAX
package's NetworkGUI decodes it (within 1e-6), served frames equal to
render()'s image clipped and quantised (exactly), PNGs decoded with the
port's own reader, and the entry point's arguments.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hidegs_tpu.viewer.network_gui import NetworkGUI as JNetworkGUI
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.utils import png
from hidegs_tpu_torch.viewer import __main__ as viewer_main
from hidegs_tpu_torch.viewer.http_viewer import HttpViewer, orbit_camera
from hidegs_tpu_torch.viewer.network_gui import NetworkGUI, camera_from_message, image_bytes

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _client_message(width, height, view, fov_x=0.8, fov_y=0.6, train=True):
    return {
        "resolution_x": width, "resolution_y": height, "train": train, "fov_x": fov_x, "fov_y": fov_y,
        "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False, "keep_alive": True,
        "scaling_modifier": 1.0, "view_matrix": view, "view_projection_matrix": view,
    }


def _send_msg(sock, msg: dict):
    payload = json.dumps(msg).encode("utf-8")
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def _reference_view_matrix(R, t):
    """The wire-format matrix the SIBR client sends: the row-major torch
    world→cam transpose with columns 1, 2 negated."""
    Rt = np.eye(4, dtype=np.float32)
    Rt[:3, :3] = R
    Rt[:3, 3] = t
    view = Rt.T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    return [float(x) for x in view.reshape(-1)]


def _poll_until_served(gui, render_fn, verify, deadline_s=15.0):
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        if gui.poll(render_fn, verify=verify) is not None:
            return
        time.sleep(0.002)
    raise AssertionError("GUI never served the client within the deadline")


def _pose(th=0.3):
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    return R, np.array([0.1, -0.2, 3.0], np.float32)


def _serve_one(gui, msg, render_fn, verify, n_image_bytes):
    """A client thread sends `msg`; the GUI polls until it has answered.
    Returns the image bytes and the verify string the client read."""
    port = gui.listener.getsockname()[1]
    seen = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            _send_msg(s, msg)
            seen["img"] = _recv_exact(s, n_image_bytes) if n_image_bytes else b""
            n = struct.unpack("<I", _recv_exact(s, 4))[0]
            seen["verify"] = _recv_exact(s, n).decode("ascii")

    th = threading.Thread(target=client)
    th.start()
    _poll_until_served(gui, render_fn, verify)
    th.join(timeout=30)
    gui.close()
    assert not th.is_alive()
    return seen


def test_network_gui_round_trip():
    """tests/test_viewer.py::test_network_gui_round_trip on the port."""
    gui = NetworkGUI(port=0, device="cpu")
    W, H = 32, 24
    R, t = _pose()
    msgs = []

    def render_fn(cam, msg):
        np.testing.assert_allclose(cam.R.numpy(), R, atol=1e-5)
        np.testing.assert_allclose(cam.t.numpy(), t, atol=1e-5)
        assert cam.width == W and cam.height == H and cam.device.type == "cpu"
        msgs.append(msg)
        img = torch.zeros((3, cam.height, cam.width))
        img[0] = 1.0  # pure red
        img[1, 0, 0] = 0.5  # one marker pixel
        return img

    seen = _serve_one(gui, _client_message(W, H, _reference_view_matrix(R, t)), render_fn, "modelpath", H * W * 3)
    assert seen["verify"] == "modelpath" and msgs[0]["train"] is True
    img = np.frombuffer(seen["img"], np.uint8).reshape(H, W, 3)
    assert (img[:, :, 0] == 255).all()
    assert img[0, 0, 1] == 127  # 0.5·255 truncated, as the JAX viewer does
    assert (img[1:, :, 1] == 0).all() and (img[:, :, 2] == 0).all()


def test_network_gui_empty_resolution_skips_render():
    """tests/test_viewer.py::test_network_gui_empty_resolution_skips_render."""
    calls = []

    def render_fn(cam, msg):
        calls.append(1)
        return np.zeros((3, 1, 1), np.float32)

    seen = _serve_one(NetworkGUI(port=0, device="cpu"), _client_message(0, 0, [0.0] * 16, train=False),
                      render_fn, "v", 0)
    assert seen["verify"] == "v" and not calls


@pytest.mark.parametrize("th", [0.3, -1.1])
def test_pose_message_decodes_as_jax(th):
    R, t = _pose(th)
    msg = _client_message(40, 30, _reference_view_matrix(R, t), fov_x=0.9, fov_y=0.7)
    jgui = JNetworkGUI(port=0)
    try:
        jgui.read_message = lambda: msg  # the JAX GUI's decoder on the same message
        jcam, _ = jgui.receive_camera()
    finally:
        jgui.close()
    cam = camera_from_message(msg, device="cpu")
    for name in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(cam, name).numpy(), np.asarray(getattr(jcam, name)), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    assert (cam.height, cam.width) == (jcam.height, jcam.width)


def test_http_viewer_serves_rendered_frames():
    """tests/test_viewer.py::test_http_viewer_serves_frames on the port: the
    page, the info, and a PNG frame whose pixels are render()'s image
    clipped and quantised; a repeated request is served from the cache."""
    scene = tsyn.make_toy_gaussians(80, seed=0, device="cpu")
    cfg = RasterConfig(max_instances=1 << 12)
    render_fn = viewer_main.make_render_fn(scene, cfg)
    viewer = HttpViewer(render_fn, center=(0, 0, 0), dist=6.0, host="127.0.0.1", port=0, width=64, height=48,
                        info={"n_gaussians": 80}, device="cpu")
    viewer.serve_background()
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        page = urllib.request.urlopen(base + "/", timeout=30).read()
        assert b"hidegs_tpu viewer" in page
        assert json.loads(urllib.request.urlopen(base + "/info", timeout=30).read())["n_gaussians"] == 80
        url = base + "/frame?yaw=0.5&pitch=0.8&dist=6&w=64&h=48"
        try:
            frame = urllib.request.urlopen(url, timeout=60).read()
        except urllib.error.HTTPError as e:  # surface the server-side error
            raise AssertionError(f"/frame failed: {e.code} {e.read().decode()}")
        arr = png.decode_png(frame)
        assert arr.shape == (48, 64, 3) and arr.std() > 0
        cam = orbit_camera(0.5, 0.8, 6.0, (0.0, 0.0, 0.0), 48, 64, device="cpu")
        want = image_bytes(torch.clamp(render(*scene, cam, config=cfg)["render"], 0, 1))
        np.testing.assert_array_equal(arr, want)
        assert urllib.request.urlopen(url, timeout=60).read() == frame
        assert len(viewer._cache) == 1
    finally:
        viewer.shutdown()


def test_viewer_arguments_and_device():
    args = viewer_main.parse_args(["--model_path", "m"])
    assert (args.device, args.backend, args.port, args.http, args.iteration) == ("cuda", "jnp", 6009, 0, -1)
    args = viewer_main.parse_args(["--model_path", "m", "--device", "cpu", "--http", "8080", "--backend", "pallas"])
    assert (args.device, args.http, args.backend) == ("cpu", 8080, "pallas")
    with pytest.raises(SystemExit):
        viewer_main.parse_args([])  # --model_path is required


def test_python_m_viewer_serves_a_model_on_the_cpu(tmp_path):
    """`python -m hidegs_tpu_torch.viewer --device cpu --http <port>` on a
    model directory: the browser viewer starts and serves a frame."""
    from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply

    scene = tsyn.make_toy_gaussians(60, seed=3, device="cpu")
    ckpt = tmp_path / "model" / "point_cloud" / "iteration_5"
    ckpt.mkdir(parents=True)
    op = scene.opacities.double()
    write_ply(str(ckpt / "point_cloud.ply"), gaussian_properties(
        scene.means3d.numpy(), scene.shs[:, 0].numpy(), scene.shs[:, 1:].numpy(),
        torch.log(op / (1 - op)).float().numpy(), torch.log(scene.scales).numpy(), scene.quats.numpy()))
    with socket.socket() as s:  # a free port (--http 0 means the socket protocol, as in JAX)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "hidegs_tpu_torch.viewer", "--model_path", str(tmp_path / "model"),
         "--device", "cpu", "--http", str(port), "--max_instances", "4096"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"browser viewer on http://127.0.0.1:{port} (iteration 5)" in line, \
            line + (proc.stderr.read() if proc.poll() is not None else "")
        base = f"http://127.0.0.1:{port}"
        info = json.loads(urllib.request.urlopen(base + "/info", timeout=60).read())
        assert info == {"iteration": 5, "n_gaussians": 60}
        arr = png.decode_png(urllib.request.urlopen(base + "/frame?w=32&h=24", timeout=120).read())
        assert arr.shape == (24, 32, 3)
    finally:
        proc.kill()
        proc.communicate(timeout=30)


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_encode_png_is_the_file_write_png_writes(tmp_path, kind):
    rng = np.random.default_rng(2)
    arr = {"rgb8": rng.integers(0, 256, (9, 7, 3)).astype(np.uint8),
           "gray8": rng.integers(0, 256, (9, 7)).astype(np.uint8),
           "gray16": rng.integers(0, 65536, (9, 7)).astype(np.uint16)}[kind]
    png.write_png(str(tmp_path / "a.png"), arr)
    data = (tmp_path / "a.png").read_bytes()
    assert png.encode_png(arr) == data
    np.testing.assert_array_equal(png.decode_png(data), arr)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "a.png")), arr)
