"""Two-view geometry, batched triangulation and the fuse search of the port
against the JAX package, on the CPU.

The geometry functions get seeded random inputs. The searches get the
keyframes of a small map: the port's tracker (device "cpu") maps five
frames of a rendered sequence with a keyframe every second frame, and the
keyframe rows, poses and points go to both packages as numpy arrays (the
staging of tests/test_torch_fused_step.py; a JAX tracker would add its
compile time to the suite for the same arrays). The triangulation tests
treat every keypoint as free: depth already gives most keypoints of an
RGB-D keyframe a point, and the search should see a full set.

Tolerances: the geometry within float32 round-off (1e-5 relative; a
fundamental matrix is compared after scaling to unit norm). Triangulation:
the surviving (keypoint, neighbour, keypoint) triples equal up to a handful
(at most 3 per pair, 1 %) whose gates (chi-square, parallax, scale ratio)
sit within float32 noise of their limit; the points of common survivors
within 1e-4 relative. Fuse: the [T, N] associations equal on at least
99.5 % of the slots.
"""
import jax
import numpy as np
import pytest

from orbslam2_tpu.frontend import kernels as jk, triangulation as jtri_mod
from orbslam2_tpu.geometry import triangulate as jtri
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend import kernels as tk, triangulation as ttri_mod
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker
from orbslam2_tpu_torch.geometry import se3 as tse3, triangulate as ttri
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig

from torch_port_helpers import j, n, t

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)
SF, NL = 1.2, 4
NB_CAP = 12


def _rel(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(n(a), n(b), rtol=rtol, atol=atol)


def _poses(rng, k):
    xi = np.concatenate([rng.normal(size=(k, 3)) * 0.3, rng.normal(size=(k, 3)) * 0.1], 1)
    return n(tse3.exp(t(xi.astype(np.float32))))


@jax.jit
def _jax_geometry(kmat, tcw1, tcw2, uv1, uv2, pts, c1, c2):
    """Every JAX geometry output of the test, as one compiled program."""
    p1, p2 = jtri.projection_matrix(kmat, tcw1), jtri.projection_matrix(kmat, tcw2)
    f12 = jtri.fundamental_from_poses(kmat, tcw1, kmat, tcw2)
    e, z = jtri.reprojection_error_sq(kmat, tcw1, pts, uv1)
    return dict(p1=p1, p2=p2, dlt=jtri.triangulate_dlt(p1[None], p2[None], uv1, uv2),
                f12=f12, epi=jtri.epipolar_distance_sq(uv1, uv2, f12),
                pcos=jtri.parallax_cos(c1, c2, pts), rep_e=e, rep_z=z,
                pair=jtri_mod._pairwise_epipolar(uv1, uv2, f12))


def test_geometry_functions_match_jax():
    rng = np.random.default_rng(0)
    kmat = np.array([[260, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
    tcw1, tcw2 = _poses(rng, 2)
    uv1 = rng.uniform([0, 0], [320, 240], (200, 2)).astype(np.float32)
    uv2 = uv1 + rng.normal(size=(200, 2)).astype(np.float32) * 5
    pts = rng.uniform([-2, -2, 2], [2, 2, 8], (200, 3)).astype(np.float32)
    c1, c2 = (n(tse3.camera_center(t(p))) for p in (tcw1, tcw2))
    jo = {k: n(v) for k, v in _jax_geometry(
        *(j(a) for a in (kmat, tcw1, tcw2, uv1, uv2, pts, c1, c2))).items()}

    p1t, p2t = ttri.projection_matrix(t(kmat), t(tcw1)), ttri.projection_matrix(t(kmat), t(tcw2))
    _rel(p1t, jo["p1"])
    _rel(p2t, jo["p2"])
    _rel(ttri.triangulate_dlt(p1t[None], p2t[None], t(uv1), t(uv2)), jo["dlt"],
         rtol=1e-4, atol=1e-4)
    f_t = n(ttri.fundamental_from_poses(t(kmat), t(tcw1), t(kmat), t(tcw2)))
    f_j = jo["f12"]
    _rel(f_t / np.linalg.norm(f_t), f_j / np.linalg.norm(f_j), atol=1e-7)
    _rel(ttri.epipolar_distance_sq(t(uv1), t(uv2), t(f_j)), jo["epi"], rtol=1e-4)
    _rel(ttri.parallax_cos(t(c1), t(c2), t(pts)), jo["pcos"])
    e, z = ttri.reprojection_error_sq(t(kmat), t(tcw1), t(pts), t(uv1))
    _rel(e, jo["rep_e"], rtol=1e-4)
    _rel(z, jo["rep_z"])
    _rel(ttri_mod._pairwise_epipolar(t(uv1), t(uv2), t(f_j)), jo["pair"],
         rtol=1e-4, atol=1e-4)
    # a point the DLT sees exactly is recovered
    exact = np.stack([kmat @ (tcw[:3, :3] @ pts[0] + tcw[:3, 3]) for tcw in (tcw1, tcw2)])
    uv_exact = (exact[:, :2] / exact[:, 2:]).astype(np.float32)
    x = n(ttri.triangulate_dlt(p1t, p2t, t(uv_exact[0]), t(uv_exact[1])))
    np.testing.assert_allclose(x, pts[0], rtol=1e-4)


@pytest.fixture(scope="module")
def keyframes():
    seq = SyntheticSequence(JCAM, n_frames=5, trajectory="lateral", seed=1)
    cfg = SLAMConfig(cam=TCAM, orb=ORBConfig(n_features=800, n_levels=NL),
                     th_depth=4.0, max_keyframes=8, max_points=4096,
                     local_point_cap=2048, min_init_features=300, force_kf_every=2,
                     async_mapping=False, pipelined_fetch=False)
    tr = Tracker(cfg, device="cpu")
    for i in range(5):
        gray, depth = seq.render(i)
        assert tr.track_rgbd(gray, depth, i / 30.0) is not None
    m = tr.map
    kfs = [int(k) for k in m.keyframe_ids()]
    assert len(kfs) == 3
    return m, kfs


def _store_args(m, pose, module):
    """The keyframe-store arrays of both packages, in their argument order."""
    conv = j if module == "jax" else t
    desc = j(m.kf_kp_desc) if module == "jax" else convert.desc_from_numpy(m.kf_kp_desc)
    return (conv(pose), conv(m.kf_kp_xy), desc, conv(m.kf_kp_octave),
            conv(m.kf_kp_angle), conv(m.kf_kp_valid), conv(m.kf_kp_ur), conv(m.kf_kp_depth))


def _triples(nb_slot, idx1, kp2, nb_ids):
    keep = n(idx1) >= 0
    return {(int(a), int(nb_ids[b]), int(c))
            for a, b, c in zip(n(idx1)[keep], n(nb_slot)[keep], n(kp2)[keep])}


def test_triangulate_pair_matches_jax(keyframes):
    m, kfs = keyframes
    a, b = kfs[1], kfs[0]
    free = lambda k: m.kf_kp_valid[k].copy()

    def kp_np(k):
        return dict(xy=m.kf_kp_xy[k], response=m.kf_kp_response[k], angle=m.kf_kp_angle[k],
                    octave=m.kf_kp_octave[k], size=np.ones(m.cap.n_features, np.float32),
                    desc=m.kf_kp_desc[k], valid=m.kf_kp_valid[k])

    jargs = []
    targs = []
    for k in (a, b):
        fk = kp_np(k)
        jargs += [j(m.kf_pose[k]), jorb.Keypoints(**{f: j(v) for f, v in fk.items()}),
                  j(free(k)), j(m.kf_kp_ur[k]), j(m.kf_kp_depth[k])]
        targs += [t(m.kf_pose[k]), convert.keypoints_from_numpy(**fk),
                  t(free(k)), t(m.kf_kp_ur[k]), t(m.kf_kp_depth[k])]
    rj = jtri_mod.triangulate_pair(*jargs, JCAM, SF, NL)
    rt = ttri_mod.triangulate_pair(*targs, TCAM, SF, NL)
    kj, kt = n(rj.kp2_idx), n(rt.kp2_idx)
    sj, st = set(np.flatnonzero(kj >= 0)), set(np.flatnonzero(kt >= 0))
    assert len(sj) > 10
    assert len(sj ^ st) <= max(3, 0.01 * len(sj))
    both = np.array(sorted(sj & st))
    assert (kj[both] == kt[both]).mean() > 0.99
    _rel(n(rt.points)[both], n(rj.points)[both], rtol=1e-4, atol=1e-4)


def test_triangulate_neighbors_matches_jax(keyframes):
    m, kfs = keyframes
    kf, nbs = kfs[2], kfs[:2]
    nb_ids = np.zeros(NB_CAP, np.int32)
    nb_ids[:2] = nbs
    nb_valid = np.arange(NB_CAP) < 2
    free1 = m.kf_kp_valid[kf].copy()
    free2 = np.zeros((NB_CAP, m.cap.n_features), bool)
    free2[:2] = m.kf_kp_valid[nbs]
    rj = jtri_mod.triangulate_neighbors(
        np.int32(kf), j(free1), j(nb_ids), j(nb_valid), j(free2),
        *_store_args(m, m.kf_pose, "jax"), JCAM, SF, NL, 256)
    rt = ttri_mod.triangulate_neighbors(
        kf, t(free1), nbs, t(free2[:2]),
        *_store_args(m, m.kf_pose, "torch"), TCAM, SF, NL, 256)
    tj = _triples(rj.nb_slot, rj.idx1, rj.kp2_idx, nb_ids)
    tt = _triples(rt.nb_slot, rt.idx1, rt.kp2_idx, nbs)
    assert len(tj) > 10
    assert len(tj ^ tt) <= max(6, 0.01 * len(tj))
    # (neighbour, slot) order, padded with -1
    g = int((n(rt.idx1) >= 0).sum())
    order = n(rt.nb_slot)[:g] * m.cap.n_features + n(rt.idx1)[:g]
    assert (np.diff(order) > 0).all() and (n(rt.idx1)[g:] == -1).all()
    # points of common survivors
    pj = {(int(a), int(b)): p for a, b, p in zip(n(rj.idx1), n(rj.nb_slot), n(rj.points))}
    common = [(int(a), int(b), p) for a, b, p in zip(n(rt.idx1)[:g], n(rt.nb_slot)[:g],
                                                     n(rt.points)[:g]) if (a, b) in pj]
    assert len(common) >= len(tj) - 6
    _rel(np.stack([p for _, _, p in common]), np.stack([pj[(a, b)] for a, b, _ in common]),
         rtol=1e-4, atol=1e-4)


def test_fuse_targets_matches_jax(keyframes):
    """Every map point fused into each keyframe (the JAX call padded with one
    invalid target): the association matrix of both packages."""
    m, kfs = keyframes
    cap = 2048
    cand = np.flatnonzero(m.pt_valid)
    assert len(cand) > 300
    ids = np.zeros(cap, np.int32)
    ids[:len(cand)] = cand
    t_ids = np.array(kfs + [0], np.int32)
    t_val = np.array([True] * len(kfs) + [False])
    sel = np.zeros((len(t_ids), cap), bool)
    sel[:, :len(cand)] = True
    sel[1, ::2] = False                       # a per-target candidate subset
    pt = (m.pt_pos, m.pt_desc, m.pt_valid, m.pt_normal, m.pt_min_dist, m.pt_max_dist)
    store_j = _store_args(m, m.kf_pose, "jax")[:6]
    store_t = _store_args(m, m.kf_pose, "torch")[:6]
    aj = n(jk.fuse_targets(j(t_ids), j(t_val), *store_j, j(ids), j(sel),
                           *[j(a) for a in pt], 3.0, JCAM, SF, NL, 50)).astype(np.int64)
    at = n(tk.fuse_targets(kfs, *store_t, t(ids), t(sel[:len(kfs)]),
                           t(pt[0]), convert.desc_from_numpy(pt[1]),
                           *[t(a) for a in pt[2:]], 3.0, TCAM, SF, NL, 50)).astype(np.int64)
    assert at.shape == (3, m.cap.n_features) and (aj[3] == -1).all()
    assert (aj >= 0).sum() > 100
    assert (at == aj[:3]).mean() >= 0.995
