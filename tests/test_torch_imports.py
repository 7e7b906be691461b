"""The port stands alone: importing every module of orbslam2_tpu_torch, and
chip_smoke.py, pulls in neither jax nor the JAX package, and neither does a
drive whose keyframes the mapping worker's thread maps and hands to loop
closing, nor reading the port's vocabulary (its own copy of the data), nor a
dataset driver on the CPU, which needs no OpenCV, PIL, PyYAML or imageio
either (the card's machine has none of them); its entry points refuse to run
without a GPU unless the caller asks for the CPU."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import orbslam2_tpu_torch

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(orbslam2_tpu_torch.__path__,
                                          "orbslam2_tpu_torch."))

_PROBE = """
import builtins, importlib, importlib.util, io, os, sys
names = sys.argv[1:]
# every file the process opens by name (numpy's loader uses open)
opened = []
_open = builtins.open
def _spy(file, *a, **k):
    opened.append(os.path.abspath(str(file)))
    return _open(file, *a, **k)
builtins.open = _spy
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)          # defines main(), runs nothing

# a short drive whose keyframes the mapping worker's thread maps
import torch
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.place.pretrained import get_large_vocabulary
from orbslam2_tpu_torch.system import SLAMSystem, Sensor
torch.set_num_threads(1)
cam = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
cfg = SLAMConfig(cam=cam, orb=ORBConfig(n_features=400, n_levels=4), th_depth=4.0,
                 max_keyframes=8, max_points=2048, local_point_cap=1024,
                 min_init_features=200, force_kf_every=2, pipelined_fetch=False)
system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=get_large_vocabulary(), device="cpu")
seq = SyntheticSequence(cam, n_frames=5, trajectory="lateral", seed=1)
for i in range(5):
    system.track_rgbd(*seq.render(i), i / 30.0)
system.shutdown()
print("KEYFRAMES", system.map.n_keyframes(), "IN KFDB", int(system.kfdb.valid.sum()),
      "MAPPED", system.local_mapper.counts)
read = [f for f in opened if "orbslam2_tpu/" in f.replace("orbslam2_tpu_torch/", "")]

# a dataset driver on the CPU: a TUM sequence written and read by the port's
# own PNG code, the settings file by its own reader, no OpenCV anywhere
import tempfile
from orbslam2_tpu_torch.examples import rgbd_tum
from orbslam2_tpu_torch.io.datasets import export_synthetic_tum
with tempfile.TemporaryDirectory() as tmp:
    assoc = export_synthetic_tum(SyntheticSequence(cam, n_frames=3, trajectory="lateral",
                                                   seed=2), tmp)
    with open(os.path.join(tmp, "s.yaml"), "w") as f:
        f.write(chr(10).join([
            "%YAML:1.0", "Camera.fx: 260.0", "Camera.fy: 260.0", "Camera.cx: 160.0",
            "Camera.cy: 120.0", "Camera.width: 320", "Camera.height: 240", "Camera.bf: 26.0",
            "ThDepth: 40.0", "DepthMapFactor: 5000.0", "ORBextractor.nFeatures: 800",
            "ORBextractor.nLevels: 4"]))
    drv, _ = rgbd_tum.main([os.path.join(tmp, "s.yaml"), tmp, assoc, "--device", "cpu",
                            "--no-loop-closing",
                            "--trajectory-out", os.path.join(tmp, "t.txt"),
                            "--kf-trajectory-out", os.path.join(tmp, "k.txt")])
print("DRIVER TRACKED", int((~drv.tracker.trajectory_lost_mask()).sum()))

bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "orbslam2_tpu" or m.startswith("orbslam2_tpu.")
             or m.split(".")[0] in ("cv2", "PIL", "yaml", "imageio"))
print("IMPORTED", len(names), "BAD", bad, "READ", read)
sys.exit(1 if bad or read else 0)
"""


def test_every_module_is_listed():
    want = {"__init__", "system", "convert", "geometry.se3", "geometry.camera",
            "ops.orb", "ops.cuda_orb", "ops.hamming", "ops.match",
            "backend.pose_opt", "frontend.frame", "frontend.kernels",
            "frontend.tracking", "slammap.mapstate", "slammap.device_map",
            "slammap.covisibility", "slammap.point_stats", "io.synthetic",
            "io.evaluate", "io.trajectory", "utils.profiling",
            "geometry.triangulate", "frontend.triangulation", "backend.ba",
            "frontend.local_mapping", "frontend.orchestrator",
            "geometry.sim3", "geometry.sim3_np", "place.vocabulary",
            "place.pretrained", "slammap.keyframe_db", "solvers.horn",
            "solvers.epnp", "backend.sim3_opt", "backend.pose_graph",
            "frontend.loop_closing", "ops.stereo", "slammap.native",
            "io.settings", "io.png", "io.datasets", "utils.native_build",
            "examples.common", "examples.rgbd_tum", "examples.mono_tum",
            "examples.mono_kitti", "examples.mono_euroc", "examples.stereo_kitti",
            "examples.stereo_euroc", "examples.live_camera", "examples.ros_demo",
            "examples.ar_demo", "parallel.mesh", "parallel.dist_ba",
            "parallel.multi_session", "parallel.dryrun", "viewer.headless",
            "viewer.live", "viewer.ar", "viewer.raster", "io.ros_nodes", "io.jpeg"}
    have = {m[len("orbslam2_tpu_torch."):] for m in MODULES} | {"__init__"}
    assert want <= have, want - have


def test_every_jax_module_has_its_counterpart():
    """Each module of the JAX package has one of the same name in the port,
    but ops/pallas_orb.py (the TPU kernel), whose counterpart is
    ops/cuda_orb.py (the Hopper kernel's wrappers)."""
    jax_root = os.path.join(REPO, "orbslam2_tpu")
    jax_modules = {
        os.path.relpath(os.path.join(root, f), jax_root)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")           # a package: its name
        for root, _, files in os.walk(jax_root) for f in files if f.endswith(".py")}
    have = {m[len("orbslam2_tpu_torch."):] for m in MODULES} | {"__init__"}
    counterpart = {"ops.pallas_orb": "ops.cuda_orb"}
    missing = {m for m in jax_modules if counterpart.get(m, m) not in have}
    assert not missing, sorted(missing)
    # the JAX drivers under examples/ have theirs in the port's examples package
    jax_drivers = {f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                   if f.endswith(".py") and f != "__init__.py"}
    assert not {f"examples.{d}" for d in jax_drivers} - have


def test_port_and_chip_smoke_import_without_jax():
    """Every module, chip_smoke.py and a drive with the mapping worker."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, "orbslam2_tpu_torch", *MODULES],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"IMPORTED {len(MODULES) + 1} BAD [] READ []" in proc.stdout
    assert "KEYFRAMES 3 IN KFDB 3" in proc.stdout, proc.stdout
    assert "DRIVER TRACKED 3" in proc.stdout, proc.stdout


def test_sources_do_not_name_jax_imports():
    for root, _, files in os.walk(os.path.dirname(orbslam2_tpu_torch.__file__)):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                for line in text.splitlines():
                    s = line.strip()
                    assert not s.startswith(("import jax", "from jax",
                                             "import orbslam2_tpu.", "from orbslam2_tpu.",
                                             "from orbslam2_tpu import",
                                             "import orbslam2_tpu ")), (f, line)


def test_numerics_policy_is_set():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_raises_without_a_gpu():
    from orbslam2_tpu_torch.frontend.loop_closing import LoopCloser
    from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker
    from orbslam2_tpu_torch.geometry.camera import PinholeCamera
    from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
    from orbslam2_tpu_torch.slammap.keyframe_db import KeyFrameDatabase
    from orbslam2_tpu_torch.slammap.mapstate import MapCapacity, MapState
    from orbslam2_tpu_torch.system import SLAMSystem, Sensor
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    cfg = SLAMConfig(cam=PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                       width=320, height=240, bf=26.0),
                     async_mapping=False, pipelined_fetch=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem(cfg, Sensor.RGBD)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tracker(cfg)
    assert SLAMSystem(cfg, Sensor.RGBD, device="cpu").device.type == "cpu"
    # place recognition: the system with a vocabulary and the loop closer
    voc = get_default_vocabulary()
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem(cfg, Sensor.RGBD, vocabulary=voc)
    with pytest.raises(RuntimeError, match="CUDA"):
        LoopCloser(MapState(MapCapacity(8, 64, 16)), cfg.cam, KeyFrameDatabase(voc, 8))
    system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=voc, device="cpu")
    assert system.loop_closer.device.type == "cpu" and system.kfdb is not None
    assert system.local_mapper.kfdb is system.kfdb
    # stereo: the same entry point and the same default
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem(cfg, Sensor.STEREO, vocabulary=voc)
    assert SLAMSystem(cfg, Sensor.STEREO, vocabulary=voc, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
