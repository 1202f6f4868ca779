"""The network viewer on the port (``radegs_torch/viewer/network_gui.py``)
against the JAX package's ``NetworkGUI``: the same SIBR message from a
loopback client builds the same camera (R, T, fovs within 1e-6) and gets
the same reply bytes; then the train CLI with ``--ip`` serves frames while
it trains, and its last frame equals ``render`` of the final state,
quantised the same way."""

import json
import socket
import sys
import threading
import time

import numpy as np
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.viewer.network_gui import NetworkGUI as JNetworkGUI
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.renderer import render
from radegs_torch.scripts import train as train_cli
from radegs_torch.viewer.network_gui import NetworkGUI as TNetworkGUI

torch.set_num_threads(1)


def message(cam, W, H, keep_alive=False, scaling_modifier=1.0):
    """The SIBR client's message for camera ``cam`` (a JAX Camera): the
    column-major world_view with its y / z columns negated
    (network_gui.py:73-76)."""
    wv = np.asarray(cam.world_view, np.float32).T.copy()
    wv[:, 1] *= -1
    wv[:, 2] *= -1
    return {"resolution_x": W, "resolution_y": H, "train": True,
            "fov_y": float(cam.fovy), "fov_x": float(cam.fovx), "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
            "scaling_modifier": scaling_modifier, "view_matrix": wv.reshape(-1).tolist(),
            "view_projection_matrix": np.eye(4).reshape(-1).tolist()}


def recv_exact(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed")
        buf += chunk
    return buf


def exchange(s, msg):
    """Send one message; returns (frame bytes, verify string)."""
    payload = json.dumps(msg).encode()
    s.sendall(len(payload).to_bytes(4, "little") + payload)
    img = recv_exact(s, msg["resolution_x"] * msg["resolution_y"] * 3)
    n = int.from_bytes(recv_exact(s, 4), "little")
    return img, recv_exact(s, n).decode()


def connect(port, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=timeout)
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)


def test_roundtrip_matches_jax():
    H, W = 24, 32
    jcam = JCamera.look_at([1.0, 0.5, -3.0], [0, 0.2, 0], [0, 1, 0], 0.9, 0.7, 64, 48)
    msg = message(jcam, W, H, scaling_modifier=0.7)
    frame = np.random.default_rng(0).uniform(-0.1, 1.1, size=(3, H, W)).astype(np.float32)
    replies, cams = {}, {}
    for name, cls in (("jax", JNetworkGUI), ("torch", TNetworkGUI)):
        gui = cls("127.0.0.1", 0, **({"device": "cpu"} if name == "torch" else {}))
        port = gui.listener.getsockname()[1]
        out = {}

        def client():
            with connect(port) as s:
                out["reply"] = exchange(s, msg)

        t = threading.Thread(target=client)
        t.start()
        while gui.conn is None:
            gui.try_connect()

        def render_fn(cam, scale_mod):
            cams[name] = (cam, scale_mod)
            return frame if name == "jax" else torch.from_numpy(frame)

        assert gui.poll(render_fn, "srcpath", training_done=False) is True
        t.join(timeout=30)
        assert not t.is_alive()
        replies[name] = out["reply"]
        gui.drop()
    assert replies["jax"] == replies["torch"] and replies["torch"][1] == "srcpath"
    (jc, js), (tc, ts) = cams["jax"], cams["torch"]
    assert js == ts == 0.7 and (tc.width, tc.height) == (W, H)
    for a, b in ((jc.R, tc.R), (jc.T, tc.T), (jc.fovx, tc.fovx), (jc.fovy, tc.fovy)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.world_view.numpy(), np.asarray(jcam.world_view), atol=1e-6)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_serves_the_viewer(tmp_path, monkeypatch):
    """The train CLI with --ip: one frame per iteration while it trains, then
    frames of the final state until keep_alive is false; the last frame is
    ``render`` of the state the CLI returns (scaling modifier 0.8)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    iters, n_alive = 6, 9
    port = free_port()
    jcam = JCamera.look_at([0.5, 0.4, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 48, 48)
    frames, errors = [], []

    def client():
        try:
            with connect(port) as s:
                for k in range(n_alive + 1):
                    frames.append(exchange(s, message(jcam, 48, 48, keep_alive=k < n_alive,
                                                      scaling_modifier=0.8)))
        except Exception as e:  # reported by the assertions below
            errors.append(e)

    t = threading.Thread(target=client)
    t.start()
    ts, _, _ = train_cli.main(["--synthetic", "-m", str(tmp_path / "m"), "--device", "cpu",
                               "--iterations", str(iters), "--quiet", "--ip", "127.0.0.1",
                               "--port", str(port)])
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert len(frames) == n_alive + 1 and {v for _, v in frames} == {str(tmp_path / "m")}
    tcam = TCamera.create(np.array(jcam.R), np.array(jcam.T), float(jcam.fovx),
                         float(jcam.fovy), 48, 48, device="cpu")
    with torch.no_grad():
        want = render(ts.gaussians, tcam, torch.zeros(3), scaling_modifier=0.8,
                      device="cpu")["render"]
    want = (np.clip(want.numpy(), 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    assert frames[-1][0] == want.tobytes()
    assert frames[0][0] != frames[-1][0]  # the first frame came before training ended
