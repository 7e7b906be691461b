"""The CPU side of the frame-step measurement tools: how
orbslam2_tpu_torch/tools/frame_step_ab.py sums a torch.profiler window
(the card's operations, the host's kernel and graph launches, the kernels
inside graph replays), on a stand-in for ``prof.key_averages()``."""
from types import SimpleNamespace

from orbslam2_tpu_torch.tools import frame_step_ab


def _event(key, count, device="CUDA", us=0.0):
    return SimpleNamespace(key=key, count=count, device_type=SimpleNamespace(name=device),
                           self_device_time_total=us)


def test_window_counts_splits_graph_kernels_from_launches():
    events = [
        _event("cudaLaunchKernel", 7, "CPU"), _event("cudaGraphLaunch", 2, "CPU"),
        _event("cudaMemcpyAsync", 3, "CPU"), _event("aten::add", 9, "CPU"),
        _event("orient_describe_kernel(OrientDescribeTable, ...)", 2, us=16.0),
        _event("void at::native::elementwise_kernel<...>", 25, us=50.0),
        _event("Memcpy DtoD (Device -> Device)", 3, us=4.0),
        _event("Memset (Device)", 1, us=1.0),
    ]
    c = frame_step_ab.window_counts(SimpleNamespace(key_averages=lambda: events))
    assert c == dict(ops=31, kernels=27, launches=7, graphs=2, graph_kernels=20,
                     describe=2, device_ms=0.071)
