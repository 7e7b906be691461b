"""The port's dataset drivers (``python -m orbslam2_tpu_torch.examples.*``)
end to end on the CPU, at tests/test_io_drivers.py's geometry (320x240, 800
features, 4 levels): sequences written by the port's own PNG writer, run
through ``main(argv)`` with ``--device cpu`` and ``--eval``.

One comparison with the JAX package's ``examples/rgbd_tum.py``, run in
process on the same tree, holds the slice as a whole: the same frames
tracked, keyframes within 1 of each other (the mapping worker's timing may
move one keyframe decision), and each ATE under the JAX test's 0.05 m.
"""
import ast
import importlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.examples import (common, mono_euroc, mono_kitti, mono_tum,
                                         rgbd_tum, stereo_euroc, stereo_kitti)
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io import datasets, png
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)
from test_io_drivers import SETTINGS_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
ATE_MAX_M = 0.05          # tests/test_io_drivers.py's and test_first_contact.py's limit
MONO_ATE_MAX_M = 0.06     # tests/test_e2e_mono.py's limit (Sim3 alignment)
DRIVERS = {"rgbd_tum": (rgbd_tum, 2), "mono_tum": (mono_tum, 2),
           "mono_kitti": (mono_kitti, 1), "stereo_kitti": (stereo_kitti, 1),
           "mono_euroc": (mono_euroc, 2), "stereo_euroc": (stereo_euroc, 2)}


def _eval_lines(text):
    return [ast.literal_eval(ln[5:].strip()) for ln in text.splitlines()
            if ln.startswith("eval:")]


def _outputs(tmp_path, name):
    return ["--trajectory-out", str(tmp_path / f"{name}.txt"),
            "--kf-trajectory-out", str(tmp_path / f"{name}_kf.txt")]


@pytest.fixture(scope="module")
def tum_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    seq = SyntheticSequence(CAM, n_frames=10, trajectory="lateral", seed=2)
    seq.n_frames = 8         # the first 8 frames of a 10-frame drive
    assoc = datasets.export_synthetic_tum(seq, str(root / "seq"))
    settings = root / "settings.yaml"
    settings.write_text(SETTINGS_YAML)
    return str(settings), str(root / "seq"), assoc


def test_rgbd_tum_against_the_jax_driver(tum_tree, tmp_path, monkeypatch, capsys):
    settings, root, assoc = tum_tree
    gt = os.path.join(root, "groundtruth.txt")
    system, ev = rgbd_tum.main([settings, root, assoc, "--device", "cpu",
                                "--no-loop-closing", "--eval", gt,
                                *_outputs(tmp_path, "ours")])
    out = capsys.readouterr().out
    assert "tracked 8 frames" in out and _eval_lines(out) == [ev]
    assert system.device.type == "cpu" and system.loop_closer is None
    assert not system.tracker.trajectory_lost_mask().any()
    assert ev["n_associated"] == 8 and ev["ate_rmse_m"] < ATE_MAX_M
    ours = np.loadtxt(tmp_path / "ours.txt")
    ours_kf = np.loadtxt(tmp_path / "ours_kf.txt", ndmin=2)
    assert ours.shape == (8, 8) and len(ours_kf) == system.map.n_keyframes()

    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setattr(sys, "argv", ["rgbd_tum.py", settings, root, assoc,
                                      "--no-loop-closing", "--eval", gt,
                                      *_outputs(tmp_path, "theirs")])
    importlib.import_module("examples.rgbd_tum").main()
    (theirs_ev,) = _eval_lines(capsys.readouterr().out)
    theirs = np.loadtxt(tmp_path / "theirs.txt")
    theirs_kf = np.loadtxt(tmp_path / "theirs_kf.txt", ndmin=2)
    np.testing.assert_array_equal(ours[:, 0], theirs[:, 0])      # the same frames tracked
    assert abs(len(ours_kf) - len(theirs_kf)) <= 1
    assert theirs_ev["n_associated"] == ev["n_associated"]
    assert theirs_ev["ate_rmse_m"] < ATE_MAX_M


def test_stereo_kitti_driver(tmp_path, capsys):
    """test_first_contact.py's KITTI tree (the first 6 frames of a 40-frame
    lateral drive), written by the port; loop closing on with the largest shipped
    vocabulary; KITTI-format ground truth, index association."""
    root = tmp_path / "00"
    seq = SyntheticSequence(CAM, n_frames=40, trajectory="lateral", seed=2)
    for i in range(6):
        for sub, img in zip(("image_0", "image_1"), seq.render_stereo(i)[:2]):
            os.makedirs(root / sub, exist_ok=True)
            png.imwrite(str(root / sub / f"{i:06d}.png"),
                        np.clip(np.round(img), 0, 255).astype(np.uint8))
    np.savetxt(str(root / "times.txt"), np.arange(6) / seq.fps, fmt="%.6e")
    np.savetxt(str(root / "poses.txt"), np.stack(
        [np.linalg.inv(seq.poses[i])[:3, :4].reshape(-1) for i in range(6)]), fmt="%.9e")
    settings = tmp_path / "settings.yaml"
    settings.write_text(SETTINGS_YAML)
    system, ev = stereo_kitti.main([
        str(settings), str(root), "--device", "cpu", "--eval", str(root / "poses.txt"),
        "--kitti-trajectory-out", str(tmp_path / "kitti.txt"), *_outputs(tmp_path, "s")])
    assert "tracked 6 frames" in capsys.readouterr().out
    assert system.vocabulary.n_words == 10000 and system.loop_closer is not None
    cap = system.map.cap
    assert (cap.max_keyframes, cap.max_points) == (2048, 200_000)      # the capacity hint
    assert ev["n_associated"] == 6 and ev["ate_rmse_m"] < ATE_MAX_M
    assert np.loadtxt(tmp_path / "kitti.txt").shape == (6, 12)


def test_kitti_eval_pairs_frame_i_with_row_i(tmp_path, monkeypatch):
    """KITTI ground truth has no timestamps: frame i pairs with row i, also
    where the frames before initialisation are lost. The JAX driver pairs
    the tracked frames with the first rows instead, so on the same tracker
    its ATE is that of a trajectory shifted by the lost frames."""
    rng = np.random.default_rng(3)
    n, n_lost = 20, 5
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    for i in range(n):
        w = rng.normal(0, 0.2, 3)
        gt[i, :3, :3] = torch.linalg.matrix_exp(torch.tensor(
            [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])).numpy()
    poses = tmp_path / "poses.txt"
    np.savetxt(poses, gt[:, :3, :4].reshape(n, 12), fmt="%.12e")
    est = gt.copy()
    est[:n_lost] = np.eye(4)             # what a tracker holds for its lost frames
    lost = np.arange(n) < n_lost
    tracker = SimpleNamespace(full_trajectory_twc=lambda: est,
                              trajectory=[SimpleNamespace(timestamp=i / 10) for i in range(n)],
                              trajectory_lost_mask=lambda: lost)
    system = SimpleNamespace(tracker=tracker)
    ours = common.evaluate_trajectory(
        system, common.build_parser("x").parse_args(["s.yaml", "--eval", str(poses)]))
    assert ours["n_associated"] == n - n_lost and ours["ate_rmse_m"] == 0.0
    monkeypatch.syspath_prepend(REPO)
    jax_common = importlib.import_module("examples.common")
    theirs = jax_common.evaluate_trajectory(
        system, jax_common.build_parser("x").parse_args(["s.yaml", "--eval", str(poses)]))
    assert theirs["n_associated"] == n - n_lost and theirs["ate_rmse_m"] > 0.1


def test_mono_tum_driver(tmp_path):
    """The first 10 frames of test_e2e_mono.py's lateral drive in TUM layout,
    with --eval-scale: initialized, nothing lost after, ATE under that
    test's limit after Sim3 alignment."""
    seq = SyntheticSequence(CAM, n_frames=40, trajectory="lateral", seed=5)
    seq.n_frames = 10
    assoc = datasets.export_synthetic_tum(seq, str(tmp_path / "seq"))
    settings = tmp_path / "settings.yaml"
    settings.write_text(SETTINGS_YAML)
    system, ev = mono_tum.main([
        str(settings), str(tmp_path / "seq"), assoc, "--device", "cpu", "--no-loop-closing",
        "--eval", str(tmp_path / "seq" / "groundtruth.txt"), "--eval-scale",
        *_outputs(tmp_path, "m")])
    lost = system.tracker.trajectory_lost_mask()
    first = int(np.flatnonzero(~lost)[0])
    assert first < 8 and not lost[first:].any()
    assert ev["scale_aligned"] and ev["n_associated"] == 10 - first
    assert ev["ate_rmse_m"] < MONO_ATE_MAX_M


def test_device_trace_writes_a_chrome_trace(tum_tree, tmp_path):
    settings, root, assoc = tum_tree
    trace_dir = tmp_path / "trace"
    rgbd_tum.main([settings, root, assoc, "--device", "cpu", "--no-loop-closing",
                   "--max-frames", "1", "--device-trace", str(trace_dir),
                   *_outputs(tmp_path, "t")])
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert np.loadtxt(tmp_path / "t.txt", ndmin=2).shape == (1, 8)


def test_drivers_have_the_jax_flags_and_device(monkeypatch):
    """The JAX drivers' flags (examples/common.py), the live viewer's
    included, plus --device, whose default is the card."""
    monkeypatch.syspath_prepend(REPO)
    jax_common = importlib.import_module("examples.common")
    theirs = {s for a in jax_common.build_parser("x")._actions for s in a.option_strings}
    ours = {s for a in common.build_parser("x")._actions for s in a.option_strings}
    assert ours == theirs | {"--device"}
    args = common.build_parser("x").parse_args(["s.yaml"])
    assert args.device == "cuda" and not args.viewer and args.viewer_dir == "."
