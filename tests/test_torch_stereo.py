"""The port's stereo matcher (ops/stereo.py) and its paired extraction
against the JAX package, on one rendered pair (the SAD search on crafted
blocks is in test_torch_stereo_sad.py; the frame build, the fused stereo
step and SLAMSystem.track_stereo in test_torch_stereo_drive.py).

Tolerances, and why: ``match_stereo`` given the same keypoints and
pyramids: the only arithmetic that differs is the order in which the 121
absolute differences of a SAD are summed in float32. A near-tie between two
SAD offsets may therefore flip the argmin: at most 2 keypoints of the 800
may be matched in one package and not in the other, and uR / depth agree
within 1e-3 px / 1e-3 m everywhere else.
"""
import jax
import numpy as np
import pytest
import torch

from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import stereo as jst
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops import cuda_orb, orb as torb, stereo as tst

from torch_port_helpers import j, n, t, torch_keypoints

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
