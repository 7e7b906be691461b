"""The device side of one tracked frame, `_fused_track_core`, and the search
steps it is made of, against the JAX package on a staged map.

Staging: the port's tracker (device "cpu") initialises a map on frame 0 of a
rendered sequence and tracks frame 1; the state it then holds — last frame,
associations, local selection, map arrays — and the built frame 2 are handed
as numpy arrays to both packages.

Tolerances: the integer searches must agree exactly (same descriptors, same
float32 projections up to noise far below the window sizes). After a pose
optimization the two poses differ by float32 noise, so a point at the very
edge of a search window or of the chi-square gate may fall on either side:
final associations must agree on at least 98 % of the keypoint slots, and the
pose within 1e-3 in twist norm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.frontend import kernels as jk
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend import frame as tframe, kernels as tk
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig

from torch_port_helpers import HostRead, j, jax_keypoints, n, no_host_reads, t

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)
SF, NL = 1.2, 4


@pytest.fixture(scope="module")
def staged():
    seq = SyntheticSequence(JCAM, n_frames=25, trajectory="lateral", seed=1)
    cfg = SLAMConfig(cam=TCAM, orb=ORBConfig(n_features=800, n_levels=NL),
                     th_depth=4.0, max_keyframes=16, max_points=4096,
                     local_point_cap=1024, min_init_features=300,
                     async_mapping=False, pipelined_fetch=False)
    tr = Tracker(cfg, device="cpu")
    for i in range(2):
        gray, depth = seq.render(i)
        assert tr.track_rgbd(gray, depth, i / 30.0) is not None
    gray, depth = seq.render(2)
    kp, ur, d = tframe._rgbd_build(tr.extractor, TCAM, t(gray), t(depth))
    m = tr.map
    s = dict(
        kp=convert.keypoints_to_numpy(kp), ur=n(ur), depth=n(d),
        last_kp=convert.keypoints_to_numpy(tr.last_frame.kp),
        last_pid=tr.last_frame.pt_ids.astype(np.int32),
        tcw_pred=(tr.velocity @ tr.last_frame.tcw).astype(np.float32),
        local_ids=tr._local_ids, local_sel=tr._local_sel,
        pt=[m.pt_pos, m.pt_desc, m.pt_valid, m.pt_normal, m.pt_min_dist, m.pt_max_dist],
        kf_desc=m.kf_kp_desc[0], kf_valid=(m.kf_pt[0] >= 0) & m.kf_kp_valid[0],
        kf_angle=m.kf_kp_angle[0], tkp=kp, tlast_kp=tr.last_frame.kp,
        gray=gray.astype(np.float32), depth_img=depth.astype(np.float32),
        extractor=tr.extractor)
    assert (s["last_pid"] >= 0).sum() > 100 and s["local_sel"].sum() > 100
    return s


def _pt_jax(s):
    return [j(a) for a in s["pt"]]


def _pt_torch(s):
    pos, desc, valid, normal, dmin, dmax = s["pt"]
    return [t(pos), convert.desc_from_numpy(desc), t(valid), t(normal), t(dmin), t(dmax)]


def test_fused_track_core_matches_jax(staged):
    s = staged
    out_j = jk._fused_track_core(
        jax_keypoints(s["kp"]), j(s["ur"]), j(s["depth"]), j(s["tcw_pred"]),
        jax_keypoints(s["last_kp"]), j(s["last_pid"]), j(s["local_ids"]),
        j(s["local_sel"]), 1.0, *_pt_jax(s), JCAM, SF, NL)
    out_t = tk._fused_track_core(
        s["tkp"], t(s["ur"]), t(s["depth"]), t(s["tcw_pred"]),
        s["tlast_kp"], t(s["last_pid"]), t(s["local_ids"]),
        t(s["local_sel"]), 1.0, *_pt_torch(s), TCAM, SF, NL)
    assert int(out_t.mm_matches) == int(out_j.mm_matches) > 100
    assert abs(int(out_t.mm_inliers) - int(out_j.mm_inliers)) <= 3
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 5
    assert int(out_j.n_inliers) > 150
    pid_t, pid_j = n(out_t.pt_ids), n(out_j.pt_ids)
    assert (pid_t == pid_j).mean() >= 0.98
    assert (n(out_t.is_outlier) == n(out_j.is_outlier)).mean() >= 0.98
    np.testing.assert_array_equal(n(out_t.visible), n(out_j.visible))
    gap = np.linalg.norm(n(jse3.log(j(n(out_t.tcw)) @ jse3.inverse(out_j.tcw))))
    assert gap < 1e-3
    assert out_t.pt_ids.shape == (s["ur"].shape[0],)


def test_projection_search_matches_jax(staged):
    """search_by_projection_last (rotation filter included) and the
    local-point search at a fixed pose: exact integer equality."""
    s = staged
    pos, _, valid = s["pt"][0], s["pt"][1], s["pt"][2]
    lp = s["last_pid"]
    last_pos = pos[np.maximum(lp, 0)]
    last_valid = (lp >= 0) & valid[np.maximum(lp, 0)]
    lk = s["last_kp"]
    for radius in (15.0, 30.0):
        r_j = jk.search_by_projection_last(
            j(s["tcw_pred"]), j(last_pos), j(last_valid), j(lk["desc"], jnp.uint32),
            j(lk["octave"]), j(lk["angle"]), jax_keypoints(s["kp"]), radius, JCAM, SF, NL)
        r_t = tk.search_by_projection_last(
            t(s["tcw_pred"]), t(last_pos), t(last_valid), s["tlast_kp"].desc,
            s["tlast_kp"].octave, s["tlast_kp"].angle, s["tkp"], radius, TCAM, SF, NL)
        for a, b in zip(r_t, r_j):
            np.testing.assert_array_equal(n(a), n(b))
        assert (n(r_j.assoc) >= 0).sum() > 100
    taken = np.zeros(len(s["ur"]), bool)
    info_j, res_j = jk.search_local_points_gathered(
        j(s["tcw_pred"]), j(s["local_ids"]), j(s["local_sel"]), *_pt_jax(s),
        jax_keypoints(s["kp"]), j(taken), 1.0, JCAM, SF, NL)
    info_t, res_t = tk.search_local_points_gathered(
        t(s["tcw_pred"]), t(s["local_ids"]).long(), t(s["local_sel"]), *_pt_torch(s),
        s["tkp"], t(taken), 1.0, TCAM, SF, NL)
    np.testing.assert_array_equal(n(info_t.visible), n(info_j.visible))
    np.testing.assert_array_equal(n(info_t.pred_level), n(info_j.pred_level))
    np.testing.assert_allclose(n(info_t.uv), n(info_j.uv), atol=1e-3)
    for a, b in zip(res_t, res_j):
        np.testing.assert_array_equal(n(a), n(b))
    assert (n(res_j.assoc) >= 0).sum() > 100


def test_search_by_descriptor_matches_jax(staged):
    s = staged
    bk_j, bd_j = jk.search_by_descriptor(
        j(s["kf_desc"]), j(s["kf_valid"]), j(s["kf_angle"]), jax_keypoints(s["kp"]), JCAM)
    bk_t, bd_t = tk.search_by_descriptor(
        convert.desc_from_numpy(s["kf_desc"]), t(s["kf_valid"]), t(s["kf_angle"]),
        s["tkp"], TCAM)
    np.testing.assert_array_equal(n(bk_t), n(bk_j))
    np.testing.assert_array_equal(n(bd_t), n(bd_j))
    assert (n(bk_j) >= 0).sum() > 50


# the staged frame's prediction moved 0.4 m along the camera's y axis and
# two of every three last-frame points dropped: 14 matches at radius 15 and
# 56 at 30, so the widening decides; unmoved, 291 at 15
WIDENING_CASES = {"few_at_15": (0.4, 3), "many_at_15": (0.0, 1)}


@pytest.mark.parametrize("case", list(WIDENING_CASES))
def test_widening_on_the_device_equals_the_host_branch(staged, case):
    """`_search_last_widening` selecting on the device (both searches, as the
    JAX package's lax.cond) gives the host branch's associations exactly."""
    s = staged
    shift, keep_every = WIDENING_CASES[case]
    pred = s["tcw_pred"].copy()
    pred[1, 3] += shift
    pos, valid, lp = s["pt"][0], s["pt"][2], s["last_pid"]
    last_valid = (lp >= 0) & valid[np.maximum(lp, 0)] & (np.arange(len(lp)) % keep_every == 0)
    lk = s["tlast_kp"]
    args = (t(pred), t(pos[np.maximum(lp, 0)]), t(last_valid), lk.desc, lk.octave,
            lk.angle, s["tkp"], TCAM, SF, NL)
    r15 = tk.search_by_projection_last(*args[:7], 15.0, *args[7:])
    n15 = int((r15.assoc >= 0).sum())
    assert (n15 < 20) == (case == "few_at_15")
    on_host = tk._search_last_widening(*args, host_branch=True)
    on_device = tk._search_last_widening(*args, host_branch=False)
    assert torch.equal(on_device, on_host)
    if n15 < 20:
        assert int((on_host >= 0).sum()) > 40
    else:
        assert torch.equal(on_host, r15.assoc)


def _core_args(s):
    return (s["tkp"], t(s["ur"]), t(s["depth"]), t(s["tcw_pred"]), s["tlast_kp"],
            t(s["last_pid"]), t(s["local_ids"]), t(s["local_sel"]), 1.0, *_pt_torch(s),
            TCAM, SF, NL)


def _assert_same_out(a, b):
    for name, x in tk._out_tensors(a).items():
        assert torch.equal(x, tk._out_tensors(b)[name]), name


def test_capture_form_reads_nothing_on_the_host(staged):
    """`_fused_track_core` in its capture form (the form a CUDA graph holds)
    under a guard that refuses every host read of a tensor: it passes and
    gives the eager form's outputs bit for bit; the eager form, which reads
    the widening's count and the LM's convergence flags, is refused."""
    args = _core_args(staged)
    eager = tk._fused_track_core(*args, host_reads=True)
    with no_host_reads():
        captured = tk._fused_track_core(*args, host_reads=False)
        with pytest.raises(HostRead):
            tk._fused_track_core(*args, host_reads=True)
    _assert_same_out(captured, eager)
    assert int(captured.n_inliers) > 150


def test_fused_rgbd_program_gives_the_eager_outputs(staged):
    """On the CPU `_fused_rgbd_program(...)` is the eager step: the frame
    build and `_fused_track_core` on the same inputs give its outputs, and
    `fused_frame_step` keeps the program in the caller's dict."""
    s = staged
    rest = (t(s["last_pid"]), t(s["local_ids"]), t(s["local_sel"]), 1.0, *_pt_torch(s))
    imgs = (t(s["gray"]), t(s["depth_img"]))
    prog = tk._fused_rgbd_program(s["extractor"], TCAM, SF, NL)
    out = prog(*imgs, t(s["tcw_pred"]), s["tlast_kp"], *rest)
    kp, ur, depth = tframe._rgbd_build(s["extractor"], TCAM, *imgs)
    _assert_same_out(out, tk._fused_track_core(
        kp, ur, depth, t(s["tcw_pred"]), s["tlast_kp"], *rest, TCAM, SF, NL))
    programs = {}
    again = tk.fused_frame_step(("rgbd", imgs), s["extractor"], TCAM, SF, NL,
                                t(s["tcw_pred"]), s["tlast_kp"], *rest, programs=programs)
    _assert_same_out(again, out)
    assert isinstance(programs["rgbd"], tk.FrameProgram) and programs["rgbd"].captures == 0
