"""Stereo in the port (ops/stereo.py, the paired extraction, the stereo frame
build, the fused stereo step and SLAMSystem.track_stereo) against the JAX
package, on the same numpy inputs.

Tolerances, and why:

- ``match_stereo`` and ``_sad_level`` given the same keypoints and pyramids:
  the only arithmetic that differs is the order in which the 121 absolute
  differences of a SAD are summed in float32. A near-tie between two SAD
  offsets may therefore flip the argmin: at most 2 keypoints of the 800 may
  be matched in one package and not in the other, and uR / depth agree
  within 1e-3 px / 1e-3 m everywhere else. On integer-valued images the sums
  are exact and the outputs identical.
- The frame build runs each package's own extractor: its blurred pyramid
  differs from JAX's by at most 0.02 grey levels and a descriptor by a few
  bits (tests/test_torch_orb.py), so a Hamming near-tie may pick another
  right keypoint too: at most 1 % of the matches may differ, uR within 1e-3
  px on the rest.
- The fused step and the drive compare poses after float32 optimisations,
  as tests/test_torch_fused_step.py and tests/test_torch_slice.py do.
"""
import jax
import numpy as np
import pytest
import torch

from orbslam2_tpu.frontend import frame as jframe
from orbslam2_tpu.frontend import kernels as jk
from orbslam2_tpu.frontend.tracking import SLAMConfig as JConfig
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import stereo as jst
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend import frame as tframe, kernels as tk
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io.evaluate import ate_rmse
from orbslam2_tpu_torch.ops import cuda_orb, orb as torb, stereo as tst
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import (beside, camera_centres, j, jax_keypoints, n, t,
                                torch_keypoints)

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)
SF, NL, NF = 1.2, 4, 800
MAX_FLIPS = 2
UR_TOL = 1e-3


def _fields(kp) -> dict:
    """The JAX package's Keypoints as writable numpy copies."""
    return {f: np.array(getattr(kp, f)) for f in
            ("xy", "response", "angle", "octave", "size", "desc", "valid")}


@pytest.fixture(scope="module")
def pair():
    """One rendered pair, extracted once by the JAX extractor; its keypoints
    and blurred pyramids go to both matchers."""
    seq = SyntheticSequence(JCAM, n_frames=2, trajectory="lateral", seed=3)
    left, right, depth_gt = seq.render_stereo(0)
    gl, gr = left.astype(np.float32), right.astype(np.float32)
    jex = jorb.ORBExtractor(jorb.ORBConfig(n_features=NF, n_levels=NL), (240, 320))
    extract = jax.jit(jex.extract_with_pyramid)
    (kl, pl), (kr, pr) = extract(j(gl)), extract(j(gr))
    budgets = tuple(jex.level_budgets)
    ur, depth = jst.match_stereo(kl, kr, pl, pr, JCAM, SF, NL, level_budgets=budgets)
    return dict(gl=gl, gr=gr, depth_gt=depth_gt, budgets=budgets, jex=jex,
                kl=_fields(kl), kr=_fields(kr), pl=[n(x) for x in pl],
                pr=[n(x) for x in pr], ur=n(ur), depth=n(depth))


def _match_port(p):
    return [n(x) for x in tst.match_stereo(
        torch_keypoints(p["kl"]), torch_keypoints(p["kr"]),
        [t(x) for x in p["pl"]], [t(x) for x in p["pr"]], TCAM, SF,
        level_budgets=p["budgets"])]


def _assert_stereo_close(ur_t, d_t, ur_j, d_j, max_differ):
    mt, mj = ur_t >= 0, ur_j >= 0
    assert (mt ^ mj).sum() <= max_differ, (mt ^ mj).sum()
    both = mt & mj
    np.testing.assert_allclose(ur_t[both], ur_j[both], atol=UR_TOL)
    np.testing.assert_allclose(d_t[both], d_j[both], atol=1e-3)
    assert (d_t[~mt] == -1).all() and (ur_t[~mt] == -1).all()


def test_match_stereo_matches_jax(pair):
    ur, depth = _match_port(pair)
    assert ur.shape == depth.shape == (NF,) and ur.dtype == np.float32
    _assert_stereo_close(ur, depth, pair["ur"], pair["depth"], MAX_FLIPS)
    assert (pair["ur"] >= 0).sum() > 150


def test_match_stereo_depth_against_ground_truth(pair):
    """The limit of tests/test_e2e_stereo.py: median relative error < 5 %."""
    _, depth = _match_port(pair)
    ok = depth > 0
    assert ok.sum() > 150, ok.sum()
    xy = pair["kl"]["xy"][ok]
    xi = np.clip(np.round(xy[:, 0]).astype(int), 0, 319)
    yi = np.clip(np.round(xy[:, 1]).astype(int), 0, 239)
    gt = pair["depth_gt"][yi, xi]
    rel = np.abs(depth[ok][gt > 0] - gt[gt > 0]) / gt[gt > 0]
    assert np.median(rel) < 0.05, np.median(rel)
    assert (rel < 0.2).mean() > 0.8


def test_match_stereo_requires_the_level_budgets(pair):
    kl, kr = torch_keypoints(pair["kl"]), torch_keypoints(pair["kr"])
    pyr = [t(x) for x in pair["pl"]]
    bad = list(pair["budgets"])
    bad[0] -= 1
    for budgets in (bad, pair["budgets"][:-1]):
        with pytest.raises(ValueError, match="level_budgets"):
            tst.match_stereo(kl, kr, pyr, pyr, TCAM, SF, level_budgets=budgets)


def _crafted_level(seed, lh=40, lw=64):
    """Integer-valued left/right blocks (exact float32 sums): a textured
    left image, the right one shifted by 7 columns, and a flat band where
    every SAD ties."""
    rng = np.random.default_rng(seed)
    bl = rng.integers(0, 256, (lh, lw)).astype(np.float32)
    br = np.roll(bl, -7, axis=1)
    bl[26:, :] = 77.0
    br[26:, :] = 77.0
    return bl, br


@pytest.mark.parametrize("s", [1.0, SF ** 2])
def test_sad_level_on_crafted_blocks(s):
    """Keypoints at every margin (windows clamped into the image, `safe`
    false), SAD minima at both ends of the strip and inside it, and tied
    SADs on a flat band: identical outputs."""
    bl, br = _crafted_level(int(s * 10))
    lh, lw = bl.shape
    xs, ys, xr0 = [], [], []
    for x in (0, 2, 5, 6, 20, 40, lw - 6, lw - 5, lw - 1):       # every column margin
        for y in (0, 4, 5, 15, lh - 6, lh - 5, lh - 1):           # every row margin
            xs.append(x)
            ys.append(y)
            xr0.append(x - 7)                                      # the true match
    for x in (20, 24, 30, 40):
        for off in (-5, -3, 0, 2, 5):                              # ends and inside
            xs.append(x)
            ys.append(12)
            xr0.append(x - 7 - off)
        xs.append(x)
        ys.append(34)                                              # flat band: ties
        xr0.append(x - 7)
    xy = np.stack([np.array(xs, np.float32), np.array(ys, np.float32)], 1) * np.float32(s)
    ur0 = np.array(xr0, np.float32) * np.float32(s)
    ur_j, safe_j = jst._sad_level(j(bl), j(br), j(xy), j(ur0), s)
    ur_t, safe_t = tst._sad_level(t(bl), t(br), t(xy), t(ur0), s)
    np.testing.assert_array_equal(n(safe_t), n(safe_j))
    np.testing.assert_array_equal(n(ur_t), n(ur_j))
    safe = n(safe_t)
    assert safe.any() and (~safe).sum() > 20
    xr = np.round(ur0 / np.float32(s))
    steps = np.round(n(ur_t) / np.float32(s) - xr)
    # every end of the strip and the ties (first minimum: offset -5) occur
    assert {-5, 5} <= set(steps[safe].astype(int).tolist())


@pytest.mark.parametrize("dists", [
    [5, 5, 10, 10, 10, 10, 21, 22, 40, 60, 99, 100],   # even count, ties at the median
    [7, 7, 7, 30, 30, 30, 30, 64, 64, 90, 120],         # odd count, one beyond TH_HIGH
    [30] * 12,                                          # every distance equal
    [101, 120, 150, 200],                               # nothing within TH_HIGH
], ids=["even_ties", "odd", "all_equal", "none"])
def test_median_sweep_with_ties(dists):
    """Left keypoint i can only match right keypoint i (own row), at Hamming
    distance dists[i]; the sweep keeps d <= 2.1 * the median over the sorted
    matched distances padded with INVALID_DIST, index n_m // 2."""
    k = len(dists)
    rng = np.random.default_rng(len(dists))
    desc_l = rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32)
    bits = np.unpackbits(desc_l.view(np.uint8), axis=1)
    for i, d in enumerate(dists):
        bits[i, rng.choice(256, d, replace=False)] ^= 1
    desc_r = np.packbits(bits, axis=1).view(np.uint32)
    y = 8.0 + 12.0 * np.arange(k)
    base = dict(response=np.ones(k, np.float32), angle=np.zeros(k, np.float32),
                octave=np.zeros(k, np.int32), size=np.full(k, 31.0, np.float32),
                valid=np.ones(k, bool))
    kl = dict(base, xy=np.stack([np.full(k, 100.0), y], 1).astype(np.float32), desc=desc_l)
    kr = dict(base, xy=np.stack([np.full(k, 90.0), y], 1).astype(np.float32), desc=desc_r)
    img = np.full((8 + 12 * k, 200), 50.0, np.float32)
    cam = dict(CAM_KW, width=200, height=img.shape[0])
    ur_j, d_j = jst.match_stereo(jax_keypoints(kl), jax_keypoints(kr), (j(img),), (j(img),),
                                 JCamera(**cam), SF, 1, level_budgets=(k,))
    ur_t, d_t = tst.match_stereo(torch_keypoints(kl), torch_keypoints(kr), [t(img)], [t(img)],
                                 TCamera(**cam), SF, level_budgets=(k,))
    np.testing.assert_array_equal(n(ur_t), n(ur_j))
    # depth = bf / disparity: XLA's CPU division may round the last bit
    # differently (it multiplies by a reciprocal)
    np.testing.assert_allclose(n(d_t), n(d_j), rtol=2e-7)
    matched = sorted(d for d in dists if d <= 100)
    padded = matched + [257] * (k - len(matched))
    median = padded[len(matched) // 2]
    want = [d <= 100 and d <= 1.5 * 1.4 * median for d in dists]
    np.testing.assert_array_equal(n(ur_t) >= 0, want)


@pytest.mark.parametrize("n_levels", [NL, 9])
def test_paired_extraction_is_two_extractions_in_one_describe_call(pair, n_levels,
                                                                   monkeypatch):
    """Both images' levels go to one call of the describe wrapper (16 levels a
    table; 9 levels an image need two); every field equals what two
    extract_with_pyramid calls give, bit for bit."""
    ex = torb.ORBExtractor(torb.ORBConfig(n_features=NF, n_levels=n_levels), (240, 320),
                           device="cpu")
    gl, gr = t(pair["gl"]), t(pair["gr"])
    singles = [ex.extract_with_pyramid(gl), ex.extract_with_pyramid(gr)]
    calls = []
    wrapper = cuda_orb.fused_orient_describe_levels

    def spy(raws, *a):
        calls.append(len(raws))
        return wrapper(raws, *a)

    monkeypatch.setattr(cuda_orb, "fused_orient_describe_levels", spy)
    paired = ex.extract_pair_with_pyramid(gl, gr)
    assert calls == ([2 * n_levels] if n_levels <= 8 else [16, 2 * n_levels - 16])
    for (kp_a, pyr_a), (kp_b, pyr_b) in zip(paired, singles):
        for f in ("xy", "response", "angle", "octave", "size", "desc", "valid"):
            assert torch.equal(getattr(kp_a, f), getattr(kp_b, f)), f
        assert all(torch.equal(a, b) for a, b in zip(pyr_a, pyr_b))
    # the shared constants are the extractor's own, for both images
    assert paired[0][0].octave is ex._slot_octave and paired[1][0].size is ex._slot_size


DRIVE_KW = dict(th_depth=4.0, max_keyframes=64, max_points=8192, local_point_cap=2048,
                max_frames_between_kf=10, min_init_features=200, pipelined_fetch=False)


@pytest.fixture(scope="module")
def jax_system():
    """The JAX SLAMSystem of test_stereo_drive_matches_jax, made once: the
    frame-build and fused-step tests run its tracker's extractor, so the
    JAX programs they compile (cached per extractor) are the drive's."""
    system = JSystem(JConfig(cam=JCAM, orb=jorb.ORBConfig(n_features=NF, n_levels=NL),
                             **DRIVE_KW), JSensor.STEREO)
    yield system
    system.shutdown()


def test_stereo_frame_build_matches_jax(pair, jax_system):
    """Each package's own extractor, matcher and undistortion on one pair."""
    kp_j, _, ur_j, d_j = jframe._stereo_program(jax_system.tracker.extractor, JCAM, SF)(
        j(pair["gl"]), j(pair["gr"]))
    tex = torb.ORBExtractor(torb.ORBConfig(n_features=NF, n_levels=NL), (240, 320),
                            device="cpu")
    kp_t, ur_t, d_t = tframe._stereo_build(tex, TCAM, t(pair["gl"]), t(pair["gr"]))
    np.testing.assert_array_equal(n(kp_t.valid), n(kp_j.valid))
    np.testing.assert_allclose(n(kp_t.xy), n(kp_j.xy), atol=1e-4)
    ur_j = n(ur_j)
    _assert_stereo_close(n(ur_t), n(d_t), ur_j, n(d_j), int(0.01 * (ur_j >= 0).sum()))
    fr = tframe.build_frame_stereo(0, 0.0, pair["gl"], pair["gr"], tex, TCAM)
    np.testing.assert_array_equal(n(fr.ur), n(ur_t))
    assert fr.pt_ids.shape == (NF,) and (fr.pt_ids == -1).all()


@pytest.fixture(scope="module")
def staged_stereo():
    """A port stereo tracker (device "cpu", inline mapping) after frames 0
    and 1 of the cluttered lateral drive; frame 2 is the step under test."""
    seq = SyntheticSequence(JCAM, n_frames=20, trajectory="lateral", seed=3, world="cluttered")
    cfg = SLAMConfig(cam=TCAM, orb=torb.ORBConfig(n_features=NF, n_levels=NL),
                     th_depth=4.0, max_keyframes=16, max_points=4096,
                     local_point_cap=1024, min_init_features=200,
                     async_mapping=False, pipelined_fetch=False)
    tr = Tracker(cfg, device="cpu")
    for i in range(2):
        left, right, _ = seq.render_stereo(i)
        assert tr.track_stereo(left, right, i / 30.0) is not None
    left, right, _ = seq.render_stereo(2)
    m = tr.map
    return dict(tr=tr, gl=left.astype(np.float32), gr=right.astype(np.float32),
                last_kp=convert.keypoints_to_numpy(tr.last_frame.kp),
                last_pid=tr.last_frame.pt_ids.astype(np.int32),
                tcw_pred=(tr.velocity @ tr.last_frame.tcw).astype(np.float32),
                local_ids=tr._local_ids, local_sel=tr._local_sel,
                pt=[m.pt_pos, m.pt_desc, m.pt_valid, m.pt_normal, m.pt_min_dist,
                    m.pt_max_dist])


def test_fused_stereo_step_matches_jax(staged_stereo, jax_system):
    """fused_frame_step(("stereo", ...)) against _fused_stereo_program: the
    limits of tests/test_torch_fused_step.py, with the frame built by each
    package's own extractor and matcher."""
    s = staged_stereo
    tr = s["tr"]
    pos, desc, valid, normal, dmin, dmax = s["pt"]
    out_j = jk._fused_stereo_program(jax_system.tracker.extractor, JCAM, SF, NL)(
        j(s["gl"]), j(s["gr"]), j(s["tcw_pred"]), jax_keypoints(s["last_kp"]),
        j(s["last_pid"]), j(s["local_ids"]), j(s["local_sel"]), 1.0,
        j(pos), j(desc), j(valid), j(normal), j(dmin), j(dmax))
    out_t = tk.fused_frame_step(
        ("stereo", (t(s["gl"]), t(s["gr"]))), tr.extractor, TCAM, SF, NL,
        t(s["tcw_pred"]), tr.last_frame.kp, t(s["last_pid"]), t(s["local_ids"]),
        t(s["local_sel"]), 1.0, t(pos), convert.desc_from_numpy(desc), t(valid),
        t(normal), t(dmin), t(dmax))
    ur_j = n(out_j.ur)
    _assert_stereo_close(n(out_t.ur), n(out_t.depth), ur_j, n(out_j.depth),
                         int(0.01 * (ur_j >= 0).sum()))
    assert abs(int(out_t.mm_matches) - int(out_j.mm_matches)) <= 3
    assert int(out_j.mm_matches) > 100
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 5
    assert (n(out_t.pt_ids) == n(out_j.pt_ids)).mean() >= 0.98
    gap = np.linalg.norm(n(jse3.log(j(n(out_t.tcw)) @ jse3.inverse(out_j.tcw))))
    assert gap < 1e-3


def test_stereo_drive_matches_jax(jax_system):
    """The whole slice: the 20-frame lateral stereo drive of
    tests/test_e2e_stereo.py through both packages' SLAMSystem.track_stereo
    (mapping worker on, pipelined fetch off). Every frame tracked, ATE under
    0.03 m, and each camera centre within 5 mm of the JAX package's."""
    seq = SyntheticSequence(JCAM, n_frames=20, trajectory="lateral", seed=3,
                            world="cluttered")
    frames = [seq.render_stereo(i)[:2] for i in range(seq.n_frames)]

    def run(system):
        try:
            ok = sum(system.track_stereo(l, r, i / seq.fps) is not None
                     for i, (l, r) in enumerate(frames))
            assert system.wait_mapping_idle(120)
            return ok, system.tracker.full_trajectory_twc(), system.map.n_keyframes()
        finally:
            system.shutdown()

    port = SLAMSystem(SLAMConfig(cam=TCAM, orb=torb.ORBConfig(n_features=NF, n_levels=NL),
                                 **DRIVE_KW), Sensor.STEREO, device="cpu")
    (ok_j, est_j, _), (ok_t, est_t, nkf_t) = beside(lambda: run(jax_system),
                                                    lambda: run(port))
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(seq.n_frames)])
    assert ok_t == ok_j == seq.n_frames
    assert ate_rmse(est_t, gt) < 0.03
    gap = np.linalg.norm(camera_centres(np.linalg.inv(est_t))
                         - camera_centres(np.linalg.inv(est_j)), axis=1)
    assert gap.max() < 5e-3, gap.max()
    assert nkf_t >= 2
