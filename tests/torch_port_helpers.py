"""Shared helpers of the tests/test_torch_*.py parity tests: the same numpy
inputs go through a JAX function of orbslam2_tpu and its PyTorch counterpart
in orbslam2_tpu_torch (device "cpu"), and the outputs are compared as numpy
arrays."""
import concurrent.futures
import contextlib
import copy
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.system import SLAMSystem as JSystem
from orbslam2_tpu_torch import convert

# The suite runs several pytest workers side by side, some of them driving
# threaded, cadence-sensitive sessions; one intra-op thread per worker keeps
# the small tensors of these tests from oversubscribing the cores.
torch.set_num_threads(1)


def t(a, dtype=None):
    """numpy -> CPU tensor (a copy: JAX hands out read-only buffers)."""
    return torch.tensor(np.asarray(a), dtype=dtype)


def j(a, dtype=None):
    """numpy -> JAX array."""
    return jnp.asarray(a, dtype=dtype)


def n(x):
    """JAX array or tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_sample_sets(valid, iters, size, seed, device="cpu"):
    """The RANSAC sample sets the JAX package draws for a seed (its split +
    choice repeated), in the signature of the port's
    ``horn.draw_sample_sets``, so that a test hands the port JAX's draws."""
    key = jax.random.PRNGKey(seed)
    probs = jnp.asarray(valid, jnp.float32) / max(int(np.sum(valid)), 1)
    keys = jax.random.split(key, iters)
    return t(np.asarray(jax.vmap(lambda k_: jax.random.choice(
        k_, len(valid), (size,), replace=False, p=probs))(keys))).long()


def desc_np(x):
    """Packed descriptors of either package -> numpy uint32 words."""
    if isinstance(x, torch.Tensor):
        return convert.desc_to_numpy(x)
    return np.asarray(x).astype(np.uint32)


def hamming_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row bit differences of two [K, 8] uint32 arrays."""
    x = np.ascontiguousarray(a ^ b).view(np.uint8)
    return np.unpackbits(x, axis=1).sum(axis=1)


def camera_centres(poses) -> np.ndarray:
    """Camera centres of Tcw poses or Sim3s [..., 4, 4] (scale divided out),
    float64."""
    p = np.asarray(n(poses), np.float64)
    s = np.cbrt(np.linalg.det(p[..., :3, :3]))
    r = p[..., :3, :3] / s[..., None, None]
    return -np.einsum("...ji,...j->...i", r, p[..., :3, 3] / s[..., None])


def angle_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(np.arctan2(np.sin(a - b), np.cos(a - b)))


def jax_keypoints(fields: dict) -> jorb.Keypoints:
    """numpy fields (desc as uint32) -> the JAX package's Keypoints."""
    return jorb.Keypoints(
        xy=j(fields["xy"]), response=j(fields["response"]),
        angle=j(fields["angle"]), octave=j(fields["octave"], jnp.int32),
        size=j(fields["size"]), desc=j(fields["desc"], jnp.uint32),
        valid=j(fields["valid"]))


def torch_keypoints(fields: dict):
    return convert.keypoints_from_numpy(
        fields["xy"], fields["response"], fields["angle"], fields["octave"],
        fields["size"], fields["desc"], fields["valid"])


def random_keypoints(rng, n_kp, width=320, height=240, n_levels=4,
                     valid_frac=0.9) -> dict:
    """Seeded numpy keypoint fields with random descriptors."""
    return dict(
        xy=rng.uniform([0, 0], [width, height], (n_kp, 2)).astype(np.float32),
        response=rng.uniform(1, 100, n_kp).astype(np.float32),
        angle=rng.uniform(-np.pi, np.pi, n_kp).astype(np.float32),
        octave=rng.integers(0, n_levels, n_kp).astype(np.int32),
        size=np.full(n_kp, 31.0, np.float32),
        desc=rng.integers(0, 2 ** 32, (n_kp, 8), dtype=np.uint32),
        valid=rng.uniform(size=n_kp) < valid_frac)


def smooth_image(seed, h, w, sigma=1.5):
    """Random image smoothed a bit so descriptors are not pure noise (the
    fixture of tests/test_pallas_orb.py)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = jorb.gaussian_kernel1d(sigma, 3)
    return np.asarray(jorb._separable_conv(jnp.asarray(img), k))


def beside(first, second):
    """-> (first(), second()), ``first`` run on a thread of its own while
    ``second`` runs on this one. For two runs that do not depend on timing
    (mapping inline, a fetch that waits for its frame), such as one drive in
    each package: both spend most of their time outside the interpreter, so
    they overlap."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        a = pool.submit(first)
        b = second()
        return a.result(), b


class HostRead(AssertionError):
    """A tensor's value was read by the host inside ``no_host_reads``."""


_HOST_READS = ("__bool__", "__int__", "__float__", "item", "tolist", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Inside the context every read of a tensor's value by Python code
    raises HostRead: ``Tensor.__bool__`` (an ``if`` on a tensor),
    ``__int__``, ``__float__``, ``item``, ``tolist`` and ``numpy``. On a card
    each of these is a host synchronisation, which a CUDA graph capture
    refuses; a step that passes under the guard on the CPU makes none of
    them. Reads inside C++ operators are not seen (a capture on the card
    refuses those)."""
    saved = {name: torch.Tensor.__dict__.get(name) for name in _HOST_READS}

    def refuse(name):
        def read(*_a, **_k):
            raise HostRead(f"Tensor.{name} inside no_host_reads")
        return read

    for name in _HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, attr in saved.items():
            if attr is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, attr)


@functools.lru_cache(maxsize=None)
def _extract_jit(extractor):
    return jax.jit(extractor.__call__)


def jax_system(cfg, sensor, vocabulary=None):
    """The JAX package's SLAMSystem, its tracker given the package's cached
    extractor for its ORB settings and image size (``orb.get_extractor``)
    and one jitted extraction for it. The JAX frame programs are cached on
    the extractor object and each Tracker builds its own, so without this
    every JAX system of a test process compiles the same programs again;
    with it, every JAX system of one configuration runs the programs the
    first one compiled. The extractor is a pure function of the settings
    and the image size, so what the system computes does not change."""
    system = JSystem(cfg, sensor, vocabulary=vocabulary)
    tracker = system.tracker
    tracker.extractor = jorb.get_extractor(cfg.orb, (cfg.cam.height, cfg.cam.width))
    tracker._extract_jit = _extract_jit(tracker.extractor)
    return system


def without_replacement_lookup(system):
    """Switch off the port's repair of replaced points on one system, for a
    parity test whose JAX drive the repair moves: the last frame's ids and
    the local selection stay as they are before each frame, and a fused
    frame's ids are kept on apply if their slot is valid and older than the
    frame's dispatch, else dropped, as before ``MapState.resolve_replaced``
    (and as the JAX package does). Patches this system's instances only.
    -> the system."""
    m = system.map

    def no_table(ids, stamp_snap):
        ids = np.asarray(ids)
        safe = np.clip(ids, 0, m.cap.max_points - 1)
        keep = (ids >= 0) & m.pt_valid[safe] & (m.pt_stamp[safe] < stamp_snap)
        return np.where(keep, ids, -1).astype(np.int32), 0, 0

    m.resolve_replaced = no_table
    system.tracker._check_replaced = lambda: None
    return system


# a tracker's collaborators, which a fork of it goes without
_COLLABORATORS = ("mapping_worker", "local_mapper", "loop_closer", "kfdb",
                  "vocabulary", "applied_pose_cb")
# what a fork shares with its tracker: settings, the extractor and its
# compiled programs, the fetch pool, the stage timer
_SHARED = ("cfg", "cam", "device", "extractor", "_extract_jit", "_fetch_pool", "stats")


def fork_tracker(tracker):
    """A copy of a Tracker of either package, with the frames in flight
    applied first: a deep copy of its map and of its per-frame state, and
    no mapper, worker, loop closer or keyframe database; a method a test
    wrapped on the tracker's instance is the class's own again on the fork.
    Tracking frames on the fork leaves the tracker as it was."""
    tracker.flush_frames()
    fork = copy.copy(tracker)
    memo = {}
    for name, value in vars(tracker).items():
        if callable(value) and hasattr(type(tracker), name):
            delattr(fork, name)
        elif name in _COLLABORATORS:
            setattr(fork, name, None)
        elif name == "map_lock":
            fork.map_lock = threading.RLock()
        elif name not in _SHARED:
            setattr(fork, name, copy.deepcopy(value, memo))
    return fork
