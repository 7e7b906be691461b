"""Batched multi-camera tracking: B sessions stepped together on one card.

Counterpart of ``orbslam2_tpu/parallel/multi_session.py``, which runs
``jax.jit(shard_map(vmap(track_step)))``: one XLA program with a session
axis on every array. The per-frame step of a session is ORB extraction ->
local-map projection matching -> robust pose LM; sessions share nothing,
every one has its own image and its own slice of a local map, all of one
static shape.

Here the step is one program too (``MultiSessionProgram``, a
``kernels.StepProgram``): on a card one CUDA graph per set of input
shapes, captured at the first call and replayed after it; on the CPU the
eager step. Inside it the B images are extracted in one batched frame
build (``ORBExtractor.extract_batch_with_pyramid``: the pyramids and FAST
selection image by image, which keeps each image's bits, then the
orientation and descriptors of all B x L levels in ceil(B * L / 16)
launches of the fused kernel); the search and the pose LM then run once
for all sessions on a leading session axis, each session with its own LM
damping, cost and convergence flag, and no read of the device by the
host. Their float sums run in ``utils/fixed_order.py``'s order, so a
session's result is the same at any B: ``make_single_camera_step`` is the
program at B = 1 and equals the batched step session by session.

The JAX step shards its sessions over a mesh; the port runs one step on
one card (``parallel/dryrun.py``'s ranks each run their own).
"""
from __future__ import annotations

from typing import Tuple

import torch

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.backend import pose_opt
from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig, Keypoints, ORBExtractor

# the descriptor distance of the session step's local-map search
MAX_HAMMING = 100


class MultiSessionProgram(kernels.StepProgram):
    """The batched step as one program: called with images [B, H, W], tcw0
    [B, 4, 4] and the local maps (pt_pos [B, C, 3], pt_desc [B, C, 8] int32
    bit-views, pt_valid [B, C], pt_normal [B, C, 3], pt_min [B, C], pt_max
    [B, C]) -> (tcw [B, 4, 4], n_inliers [B]). A replay holds ceil(B * L /
    16) describe launches."""

    def __init__(self, extractor: ORBExtractor, cam: PinholeCamera, orb_cfg: ORBConfig,
                 local_cap: int):
        super().__init__(extractor, cam, orb_cfg, local_cap)
        self.extractor, self.cam = extractor, cam
        self.orb_cfg, self.local_cap = orb_cfg, local_cap

    def run(self, images, tcw0, pt_pos, pt_desc, pt_valid, pt_normal, pt_min, pt_max
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step, eagerly (no host read inside)."""
        cfg = self.orb_cfg
        kp = Keypoints.stack([k for k, _ in self.extractor.extract_batch_with_pyramid(images)])
        b, n = kp.valid.shape
        dev = images.device
        _, res = kernels.search_local_points(
            tcw0, pt_pos, pt_desc, pt_valid, pt_normal, pt_min, pt_max, kp,
            torch.zeros((b, n), dtype=torch.bool, device=dev), 1.0, self.cam,
            cfg.scale_factor, cfg.n_levels, MAX_HAMMING)
        matched = res.assoc >= 0
        pos = torch.take_along_dim(
            pt_pos, torch.clamp(res.assoc, 0, self.local_cap - 1)[..., None], dim=-2)
        obs = kernels.build_pose_obs_from_frame(
            kp, torch.full((b, n), -1.0, device=dev), pos, matched, cfg.scale_factor)
        tcw, _, n_in = pose_opt.pose_optimization(tcw0, obs, self.cam, stop_early=False)
        return tcw, n_in

    def __call__(self, *inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        if inputs[0].device.type != "cuda":
            return self.run(*inputs)
        return self._program(list(inputs))

    def _step(self, inputs, extra):
        return self.run(*inputs)

    def _tensors(self, out):
        return out

    def _clone(self, out):
        return tuple(t.clone() for t in out)


def make_multi_camera_step(cam: PinholeCamera, orb_cfg: ORBConfig, local_cap: int,
                           device="cuda") -> MultiSessionProgram:
    """-> fn(images [B, H, W], tcw0 [B, 4, 4], pt_pos [B, C, 3], pt_desc
    [B, C, 8] int32 bit-views, pt_valid [B, C], pt_normal [B, C, 3], pt_min
    [B, C], pt_max [B, C]) -> (tcw [B, 4, 4], n_inliers [B]), every tensor on
    ``device``: the step's program."""
    device = resolve_device(device)
    return MultiSessionProgram(ORBExtractor(orb_cfg, (cam.height, cam.width), device),
                               cam, orb_cfg, local_cap)


def make_single_camera_step(cam: PinholeCamera, orb_cfg: ORBConfig, local_cap: int,
                            device="cuda"):
    """-> fn(image [H, W], tcw0 [4, 4], pt_pos [C, 3], pt_desc [C, 8] int32,
    pt_valid [C], pt_normal [C, 3], pt_min [C], pt_max [C]) -> (tcw [4, 4],
    n_inliers): one session's step, the program at B = 1 (the port's twin
    of ``__graft_entry__.entry``'s step). ``.program`` is its program."""
    program = make_multi_camera_step(cam, orb_cfg, local_cap, device)

    def step(image, tcw0, *local_map):
        tcw, n_in = program(image[None], tcw0[None], *(x[None] for x in local_map))
        return tcw[0], n_in[0]

    step.program = program
    return step
