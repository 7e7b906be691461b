"""The stereo frame build, the fused stereo step and SLAMSystem.track_stereo
of the port against the JAX package, on the same numpy inputs (the matcher
alone is in test_torch_stereo.py).

Tolerances, and why:

- The frame build runs each package's own extractor: its blurred pyramid
  differs from JAX's by at most 0.02 grey levels and a descriptor by a few
  bits (tests/test_torch_orb.py), so a Hamming near-tie may pick another
  right keypoint too: at most 1 % of the matches may differ, uR within 1e-3
  px on the rest.
- The fused step and the drive compare poses after float32 optimisations,
  as tests/test_torch_fused_step.py and tests/test_torch_system_api.py do.
"""
import numpy as np
import pytest

from orbslam2_tpu.frontend import frame as jframe
from orbslam2_tpu.frontend import kernels as jk
from orbslam2_tpu.frontend.tracking import SLAMConfig as JConfig
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend import frame as tframe, kernels as tk
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker
from orbslam2_tpu_torch.io.evaluate import ate_rmse
from orbslam2_tpu_torch.ops import orb as torb
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside, camera_centres, j, jax_keypoints, n, t
from test_torch_stereo import JCAM, NF, NL, SF, TCAM, _assert_stereo_close, pair


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
