"""The port's dataset I/O against OpenCV and the JAX package, on the CPU: the
settings reader, the PNG reader and writer, the gray conversion, the TUM,
KITTI and EuRoC loaders, the synthetic TUM export and the EuRoC rectifier.

Everything is held bit for bit, with one exception: the rectifier's maps may
differ from ``cv2.initUndistortRectifyMap``'s by one float32 ulp (the same
float64 arithmetic in another order before the cast), which left the
remapped images identical on these calibrations.
"""
import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from orbslam2_tpu.io import datasets as jdatasets
from orbslam2_tpu.io.settings import load_settings as jload_settings
from orbslam2_tpu.io.synthetic import SyntheticSequence as JSequence
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io import datasets, png, settings
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)
from test_first_contact import _closed_form_maps, _euroc_like_calib, _write_euroc_yaml
from test_io_drivers import SETTINGS_YAML

cv2 = pytest.importorskip("cv2")

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)

EUROC_CAMERA_YAML = """%YAML:1.0
---
# Camera calibration (Examples/Stereo/EuRoC.yaml's layout)
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.90639384423901   # baseline times fx
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

MAP_YAML = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k3: 0.001
Camera.fps: 0
Camera.RGB: 0
ORBextractor.nFeatures: 2000
ORBextractor.nLevels: 8
Map.MaxKeyFrames: 2048
Map.MaxPoints: 200000
Viewer.KeyFrameSize: 0.6
"""


def _write(path, text):
    path.write_text(text)
    return str(path)


def _settings_files(tmp_path):
    left, right, shape = _euroc_like_calib()
    euroc = tmp_path / "euroc.yaml"
    _write_euroc_yaml(euroc, left, right, shape)
    euroc.write_text(EUROC_CAMERA_YAML + "\n".join(euroc.read_text().splitlines()[1:]) + "\n")
    return {"tum": _write(tmp_path / "tum.yaml", SETTINGS_YAML), "euroc": str(euroc),
            "map": _write(tmp_path / "map.yaml", MAP_YAML)}


@pytest.mark.parametrize("name", ["tum", "euroc", "map"])
def test_load_settings_matches_jax_field_by_field(tmp_path, name):
    path = _settings_files(tmp_path)[name]
    ours = settings.load_settings(path, image_size=(1241, 376))
    theirs = jload_settings(path, image_size=(1241, 376))
    expected = dataclasses.asdict(theirs)
    expected["orb"].pop("use_pallas")        # the Pallas switch: not in the port
    assert dataclasses.asdict(ours) == expected
    assert ours.depth_map_factor == theirs.depth_map_factor
    assert ours.rgb_order == theirs.rgb_order
    if name == "map":
        assert (ours.max_keyframes, ours.max_points, ours.th_depth) == (2048, 200000, 3.0)
        assert ours.cam.width == 1241 and ours.max_frames_between_kf == 30
    # every node as cv2.FileStorage reads it: numbers, strings and matrices
    nodes = settings.read_opencv_yaml(path)
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    try:
        for key, value in nodes.items():
            node = fs.getNode(key)
            if isinstance(value, np.ndarray):
                ref = node.mat()
                assert value.dtype == ref.dtype and np.array_equal(value, ref), key
            else:
                assert float(value) == node.real(), key
    finally:
        fs.release()


def test_opencv_yaml_reader_dialect(tmp_path):
    path = _write(tmp_path / "d.yaml", '%YAML:1.0\n---\nA.b: 3 # int\nC: "x # y"\n'
                  'M: !!opencv-matrix\n   rows: 2\n   cols: 3\n   dt: f\n'
                  '   data: [ 1., -2.5e-1,\n       3,\n       4, 5, 6 ]\nN: 1.5\n')
    nodes = settings.read_opencv_yaml(path)
    assert nodes["A.b"] == 3 and isinstance(nodes["A.b"], int)
    assert nodes["C"] == "x # y" and nodes["N"] == 1.5
    assert nodes["M"].dtype == np.float32
    np.testing.assert_array_equal(nodes["M"], [[1, -0.25, 3], [4, 5, 6]])
    with pytest.raises(ValueError, match="not a scalar"):
        settings.read_opencv_yaml(_write(tmp_path / "n.yaml", "A:\n  b: 1\n"))
    with pytest.raises(ValueError, match="nested"):
        settings.read_opencv_yaml(_write(tmp_path / "i.yaml", "A: 1\n  b: 1\n"))
    with pytest.raises(FileNotFoundError):
        settings.read_opencv_yaml(str(tmp_path / "missing.yaml"))


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------
def _images():
    """Small images of each kind the reader takes, with noise rows, ramps
    along x and y and a texture, so that libpng's adaptive filtering picks
    every filter type somewhere."""
    rng = np.random.default_rng(0)
    h, w = 48, 64
    tex = np.clip(np.cumsum(rng.normal(0, 5, (h, w)), 1) + 128, 0, 255)
    tex[: h // 4] = rng.integers(0, 256, (h // 4, w))
    tex[h // 4: h // 2] = np.linspace(0, 255, w)[None, :]
    tex[h // 2: 3 * h // 4] = np.linspace(0, 255, h // 4)[:, None]
    tex = tex.astype(np.uint8)
    return {"gray": tex,
            "bgr": np.dstack([tex, tex[:, ::-1], 255 - tex]),
            "bgra": np.dstack([tex, tex[:, ::-1], 255 - tex, tex // 2]),
            "depth16": tex.astype(np.uint16) * 251 + rng.integers(0, 250, tex.shape,
                                                                  dtype=np.uint16)}


def _filter_types(data: bytes) -> set:
    header, idat = None, b""
    for ctype, body in png._chunks(data):
        header = struct.unpack(">IIBBBBB", body) if ctype == b"IHDR" else header
        idat += body if ctype == b"IDAT" else b""
    w, h, depth, color = header[:4]
    stride = w * {0: 1, 2: 3, 6: 4}[color] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(h)}


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "depth16"])
def test_png_reads_what_opencv_writes(tmp_path, kind, monkeypatch):
    """cv2.imwrite at several compression levels and strategies emits every
    filter type; the port decodes each file to what cv2.imread gives, by the
    C++ unfilter, and the files of level 6 by its numpy plain version."""
    img = _images()[kind]
    native_unfilter = png.unfilter
    path = str(tmp_path / "x.png")
    seen = set()
    for level in (0, 1, 6, 9):
        for strategy in range(5):
            cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level,
                                    cv2.IMWRITE_PNG_STRATEGY, strategy])
            data = open(path, "rb").read()
            seen |= _filter_types(data)
            ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            ours = png.imread(path)
            assert ours.dtype == ref.dtype and ours.shape == ref.shape
            np.testing.assert_array_equal(ours, ref)
            if level == 6:      # the numpy version is slow: one level's files
                monkeypatch.setattr(png, "unfilter", png.unfilter_plain)
                np.testing.assert_array_equal(png.decode(data), ref)
                monkeypatch.setattr(png, "unfilter", native_unfilter)
            gray = png.imread(path, gray=True)
            np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "depth16"])
def test_png_written_by_the_port_reads_back_in_opencv(tmp_path, kind):
    img = _images()[kind]
    path = str(tmp_path / "y.png")
    png.imwrite(path, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref.dtype == img.dtype
    np.testing.assert_array_equal(ref, img)
    np.testing.assert_array_equal(png.imread(path), img)


def test_png_rejects_what_it_does_not_read(tmp_path):
    assert png.imread(str(tmp_path / "missing.png")) is None
    data = png.encode(_images()["gray"])
    header = struct.pack(">IIBBBBB", 64, 48, 8, 4, 0, 0, 0)      # gray + alpha
    with pytest.raises(ValueError, match="colour type 4"):
        png.decode(data[:8] + png._chunk(b"IHDR", header) + data[33:])
    interlaced = struct.pack(">IIBBBBB", 64, 48, 8, 0, 0, 0, 1)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(data[:8] + png._chunk(b"IHDR", interlaced) + data[33:])
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + data[6:])
    bad_filter = zlib.compress(bytes([7]) + bytes(53))
    with pytest.raises(ValueError, match="filter type 7"):
        png.unfilter(zlib.decompress(bad_filter), 1, 53, 1)
    with pytest.raises(ValueError, match="cannot write"):
        png.encode(np.zeros((4, 4), np.float32))


def test_png_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f( { return 0; }\n')
    monkeypatch.setattr(png, "SOURCE", str(bad))
    monkeypatch.setattr(png, "LIB_PATH", str(tmp_path / "build" / "libpngunfilter.so"))
    with pytest.raises(RuntimeError, match="error"):
        png.build(force=True)
    assert not os.path.exists(png.LIB_PATH)


# ----------------------------------------------------------------------
# gray conversion
# ----------------------------------------------------------------------
@pytest.mark.parametrize("channels", [3, 4])
def test_to_gray_is_cvtcolor_bit_for_bit(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (256, 300, channels), dtype=np.uint8)
    for rgb_order, code in ((True, cv2.COLOR_RGB2GRAY), (False, cv2.COLOR_BGR2GRAY)):
        ours = datasets._to_gray(img, rgb_order=rgb_order)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, cv2.cvtColor(img, code).astype(np.float32))
        np.testing.assert_array_equal(ours, jdatasets._to_gray(img, rgb_order=rgb_order))
    np.testing.assert_array_equal(datasets._to_gray(img[..., 0]), img[..., 0])


# ----------------------------------------------------------------------
# dataset trees written by OpenCV, read by both packages
# ----------------------------------------------------------------------
def _write_gray(path, img):
    cv2.imwrite(str(path), np.clip(np.round(img), 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A TUM tree (the JAX package's export, plus one colour frame), a KITTI
    tree and an EuRoC tree with a comment line, all written by cv2."""
    root = tmp_path_factory.mktemp("trees")
    seq = JSequence(PinholeCamera(**CAM), n_frames=40, trajectory="lateral", seed=2)
    seq.n_frames = 3
    tum = root / "tum"
    assoc = jdatasets.export_synthetic_tum(seq, str(tum))
    gray0, _ = seq.render(0)
    colour = np.dstack([np.clip(gray0 * f, 0, 255) for f in (0.9, 1.0, 0.8)]).astype(np.uint8)
    cv2.imwrite(str(tum / "rgb" / "0.000000.png"), colour)
    kitti = root / "kitti" / "00"
    for sub in ("image_0", "image_1"):
        (kitti / sub).mkdir(parents=True)
    for i in range(3):
        left, right, _ = seq.render_stereo(i)
        _write_gray(kitti / "image_0" / f"{i:06d}.png", left)
        _write_gray(kitti / "image_1" / f"{i:06d}.png", right)
    np.savetxt(str(kitti / "times.txt"), np.arange(4) / seq.fps, fmt="%.6e")  # one too many
    euroc = root / "euroc" / "mav0"
    for sub in ("cam0", "cam1"):
        (euroc / sub / "data").mkdir(parents=True)
    lines = ["#timestamp [ns],filename"]
    for i in range(3):
        ts = 1403636579763555584 + int(i / seq.fps * 1e9)
        left, right, _ = seq.render_stereo(i)
        _write_gray(euroc / "cam0" / "data" / f"{ts}.png", left)
        _write_gray(euroc / "cam1" / "data" / f"{ts}.png", right)
        lines.append(f"{ts},{ts}.png")
    ts_path = root / "euroc" / "timestamps.txt"
    ts_path.write_text("\n".join(lines) + "\n")
    return dict(tum=(str(tum), assoc), kitti=str(kitti), euroc=(str(euroc), str(ts_path)))


def _same_items(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert type(a).__name__ == type(b).__name__
        for field in dataclasses.fields(b):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, field.name
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, field.name


def test_tum_loader_matches_jax(trees):
    tum, assoc = trees["tum"]
    assert datasets.load_tum_associations(assoc) == jdatasets.load_tum_associations(assoc)
    ours = list(datasets.tum_rgbd_frames(tum, assoc))
    _same_items(ours, list(jdatasets.tum_rgbd_frames(tum, assoc)))


def test_kitti_loaders_match_jax(trees):
    np.testing.assert_array_equal(datasets.kitti_timestamps(trees["kitti"]),
                                  jdatasets.kitti_timestamps(trees["kitti"]))
    _same_items(list(datasets.kitti_stereo_frames(trees["kitti"])),
                list(jdatasets.kitti_stereo_frames(trees["kitti"])))
    _same_items(list(datasets.kitti_mono_frames(trees["kitti"])),
                list(jdatasets.kitti_mono_frames(trees["kitti"])))


def test_euroc_loaders_match_jax(trees, tmp_path):
    root, ts_path = trees["euroc"]
    assert datasets.load_euroc_timestamps(ts_path) == jdatasets.load_euroc_timestamps(ts_path)
    _same_items(list(datasets.euroc_stereo_frames(root, ts_path)),
                list(jdatasets.euroc_stereo_frames(root, ts_path)))
    _same_items(list(datasets.euroc_mono_frames(root, ts_path)),
                list(jdatasets.euroc_mono_frames(root, ts_path)))
    # a distorted, rotated rectification shaped for these 320x240 images
    left, right, _ = _euroc_like_calib()
    scale = np.diag([320 / 752, 240 / 480, 1.0])
    calib = [(scale @ k, d, r, scale @ p) for k, d, r, p in (left, right)]
    yaml = tmp_path / "rect.yaml"
    _write_euroc_yaml(yaml, calib[0], calib[1], (240, 320))
    _same_items(list(datasets.euroc_stereo_frames(
                    root, ts_path, datasets.EurocRectifier(str(yaml), device="cpu"))),
                list(jdatasets.euroc_stereo_frames(
                    root, ts_path, jdatasets.EurocRectifier(str(yaml)))))


def test_export_synthetic_tum_matches_jax(tmp_path):
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    seq_t = SyntheticSequence(PinholeCamera(**CAM), n_frames=3, trajectory="forward", seed=4)
    seq_j = JSequence(PinholeCamera(**CAM), n_frames=3, trajectory="forward", seed=4)
    a = datasets.export_synthetic_tum(seq_t, str(ours_dir))
    b = jdatasets.export_synthetic_tum(seq_j, str(theirs_dir))
    for name in ("associations.txt", "groundtruth.txt"):
        assert (ours_dir / name).read_text() == (theirs_dir / name).read_text()
    rels = [p for _, r, d in datasets.load_tum_associations(a) for p in (r, d)]
    assert len(rels) == 6 and rels == [p for _, r, d in jdatasets.load_tum_associations(b)
                                       for p in (r, d)]
    for rel in rels:
        ours = cv2.imread(str(ours_dir / rel), cv2.IMREAD_UNCHANGED)
        theirs = cv2.imread(str(theirs_dir / rel), cv2.IMREAD_UNCHANGED)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    for r in (np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0])):
        assert datasets._rot_to_quat(r) == jdatasets._rot_to_quat(r)


# ----------------------------------------------------------------------
# EuRoC rectifier
# ----------------------------------------------------------------------
def test_rectifier_matches_opencv_and_the_closed_form(tmp_path):
    """Maps: within one float32 ulp of cv2.initUndistortRectifyMap's (1-2 of
    the 361 000 values of each map differ by one ulp), and within 0.05 px of
    the closed form over the interior (test_first_contact's limit). Images:
    the port's remap equals cv2.remap's bit for bit, with OpenCV's maps and
    with its own, and with maps reaching past every border (pixels that map
    outside are 0, neighbours outside count as 0)."""
    left, right, shape = _euroc_like_calib()
    yaml = tmp_path / "euroc.yaml"
    _write_euroc_yaml(yaml, left, right, shape)
    rect = datasets.EurocRectifier(str(yaml), device="cpu")
    rng = np.random.default_rng(7)
    raw = [np.clip(np.cumsum(rng.normal(0, 9, shape), 1) % 256, 0, 255).astype(np.uint8),
           rng.integers(0, 256, shape, dtype=np.uint8)]
    ours = rect(*raw)
    interior = (slice(40, shape[0] - 40), slice(40, shape[1] - 40))
    for (mx, my), (k, d, r, p), img, out in zip((rect.map_l, rect.map_r), (left, right),
                                                raw, ours):
        cx, cy = cv2.initUndistortRectifyMap(k, d, r, p[:3, :3], (shape[1], shape[0]),
                                             cv2.CV_32F)
        for a, b in ((mx, cx), (my, cy)):
            assert a.dtype == np.float32
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all()
        gx, gy = _closed_form_maps(k, d, r, p, shape)
        assert np.abs(mx[interior] - gx[interior]).max() < 0.05
        assert np.abs(my[interior] - gy[interior]).max() < 0.05
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, cv2.remap(img, mx, my, cv2.INTER_LINEAR))
        remap = datasets.Remap(cx, cy, "cpu")
        np.testing.assert_array_equal(remap(torch.from_numpy(img)).numpy(),
                                      cv2.remap(img, cx, cy, cv2.INTER_LINEAR))
        outside = (mx < -1) | (mx >= shape[1]) | (my < -1) | (my >= shape[0])
        assert (out[outside] == 0).all()
    # maps reaching past every border: neighbours outside count as 0
    mx = rng.uniform(-3, shape[1] + 2, shape).astype(np.float32)
    my = rng.uniform(-3, shape[0] + 2, shape).astype(np.float32)
    np.testing.assert_array_equal(datasets.Remap(mx, my, "cpu")(torch.from_numpy(raw[1])).numpy(),
                                  cv2.remap(raw[1], mx, my, cv2.INTER_LINEAR))
    # float images are blended without rounding
    f = rect.map_l
    flt = datasets.Remap(*f, "cpu")(torch.from_numpy(raw[0].astype(np.float32))).numpy()
    np.testing.assert_allclose(flt, cv2.remap(raw[0].astype(np.float32), *f, cv2.INTER_LINEAR),
                               atol=1e-3)


def test_rectifier_needs_every_matrix(tmp_path):
    yaml = tmp_path / "s.yaml"
    yaml.write_text(SETTINGS_YAML)
    with pytest.raises(ValueError, match="LEFT.K"):
        datasets.EurocRectifier(str(yaml), device="cpu")
    if not torch.cuda.is_available():
        left, right, shape = _euroc_like_calib()
        _write_euroc_yaml(yaml, left, right, shape)
        with pytest.raises(RuntimeError, match="CUDA"):
            datasets.EurocRectifier(str(yaml))
