"""Process groups for distributed bundle adjustment.

Counterpart of ``orbslam2_tpu/parallel/mesh.py``, where a 1-D device mesh
names the sharded axis. Here a rank is a process: each holds one slice of the
observation axis (``OBS_AXIS``), poses and points are replicated, and the
partial sums of a solve are added up over the group with
``torch.distributed.all_reduce``.

Backends:

- NCCL where each rank has a GPU of its own; it takes CUDA tensors only;
- gloo for CPU tensors, and for several ranks on one card (NCCL refuses two
  ranks on one device). Where the installed gloo refuses CUDA tensors, an
  all-reduce copies the tensor into pinned host memory, reduces it there and
  copies it back; the tensors the solve works on stay on the card.

Nothing here picks a device or a backend for the caller: a combination that
cannot work raises.
"""
from __future__ import annotations

import datetime
import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OBS_AXIS = "obs"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(rank: int, world_size: int, backend: str, port: int,
         timeout_s: float = 600.0) -> None:
    """``init_process_group`` at ``tcp://localhost:port``."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


class ObsGroup:
    """The ranks that share one bundle adjustment along ``OBS_AXIS``, as this
    rank sees them. Make it with ``make_group``."""

    def __init__(self, group, backend: str, device: torch.device, staged: bool):
        self.group = group
        self.backend = backend
        self.device = device
        self.staged = staged              # gloo through pinned host memory
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._host: dict = {}

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; -> ``t``. Pass a tensor of
        its own (a fresh ``index_add_`` target), never a view of state."""
        if t.device != self.device:
            raise ValueError(f"tensor on {t.device}, the group works on {self.device}")
        if not self.staged:
            dist.all_reduce(t, group=self.group)
            return t
        key = (t.numel(), t.dtype)
        host = self._host.get(key)
        if host is None:
            host = self._host[key] = torch.empty(t.numel(), dtype=t.dtype,
                                                 pin_memory=t.device.type == "cuda")
        host.copy_(t.reshape(-1))          # waits for the tensor's producers
        dist.all_reduce(host, group=self.group)
        t.copy_(host.view(t.shape))
        return t

    def obs_slice(self, n_obs: int) -> slice:
        """This rank's contiguous share of ``n_obs`` observations."""
        if n_obs % self.size:
            raise ValueError(f"pad the observations ({n_obs}) to a multiple of the "
                             f"group's size ({self.size})")
        per = n_obs // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_group(ranks: Optional[Sequence[int]] = None, backend: str = "gloo",
               device="cuda") -> Optional[ObsGroup]:
    """An ``ObsGroup`` of ``ranks`` (default: every rank of the initialised
    world) on ``device``. Every rank of the world must call it, as
    ``torch.distributed.new_group`` requires; a rank outside ``ranks`` gets
    None. Raises where ``backend`` cannot reduce tensors of ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first (mesh.init)")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(ranks)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL reduces CUDA tensors only; use gloo for the CPU")
        if len(ranks) > torch.cuda.device_count():
            raise ValueError(f"NCCL needs a GPU for each of the {len(ranks)} ranks and "
                             f"{torch.cuda.device_count()} are visible; several ranks on "
                             f"one card take gloo")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")
    elif device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA group was asked for and no GPU is available")
    group = dist.new_group(ranks, backend=backend)
    if dist.get_rank() not in ranks:
        return None
    staged = False
    if backend == "gloo" and device.type == "cuda":
        # every rank of the group has the same gloo, so all take one branch
        probe = torch.ones(1, device=device)
        try:
            dist.all_reduce(probe, group=group)
            staged = float(probe) != len(ranks)
        except RuntimeError:
            staged = True
    return ObsGroup(group, backend, device, staged)


def _run_rank(rank: int, fn: Callable, world_size: int, backend: str, port: int,
              args: tuple) -> None:
    torch.set_num_threads(1)
    init(rank, world_size, backend, port)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, args: tuple = ()) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes,
    each in the process group at a free localhost port; returns when all
    have ended and raises if one raised. ``fn`` must be importable by name
    (a module-level function)."""
    mp.start_processes(_run_rank, args=(fn, world_size, backend, free_port(), args),
                       nprocs=world_size, join=True, start_method="spawn")
