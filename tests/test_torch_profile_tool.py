"""tools/torch_port_profile.py's split of the device's idle time by what
the host does meanwhile, on hand-made Chrome trace events (the tool itself
needs a CUDA card): the gaps between device intervals, the part of them
spent in a synchronize, a launch or the allocator, and the host's own
remainder; nested calls count once, overlapping device work is one busy
interval."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_profile", os.path.join(ROOT, "tools", "torch_port_profile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel(ts, dur, cat="kernel"):
    return {"cat": cat, "name": "k", "ts": ts, "dur": dur}


def call(name, ts, dur):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur}


def test_idle_split_by_host_activity():
    events = [kernel(0, 10), kernel(20, 10), kernel(50, 5, "gpu_memset"),
              call("cudaStreamSynchronize", 5, 20),
              call("cudaLaunchKernel", 33, 2), call("cudaMalloc", 40, 3),
              # a launch inside the synchronize's window counts once
              call("cudaLaunchKernel", 12, 2),
              {"cat": "cpu_op", "name": "aten::add", "ts": 30, "dur": 20}]
    got = tool().idle_breakdown(events)
    assert got["window_ms"] == pytest.approx(0.055)
    assert got["busy_ms"] == pytest.approx(0.025)
    assert got["idle_ms"] == pytest.approx(0.030)
    assert got["sync_wait_ms"] == pytest.approx(0.010)
    assert got["launch_ms"] == pytest.approx(0.002)
    assert got["allocator_ms"] == pytest.approx(0.003)
    assert got["host_ms"] == pytest.approx(0.015)
    parts = sum(got[k] for k in ("sync_wait_ms", "launch_ms", "allocator_ms",
                                 "host_ms"))
    assert parts == pytest.approx(got["idle_ms"])


def test_overlapping_device_work_is_one_interval():
    events = [kernel(0, 10), kernel(5, 10), kernel(30, 10),
              call("cudaDeviceSynchronize", 15, 5)]
    got = tool().idle_breakdown(events)
    assert got["busy_ms"] == pytest.approx(0.025)
    assert got["idle_ms"] == pytest.approx(0.015)
    assert got["sync_wait_ms"] == pytest.approx(0.005)
    assert got["host_ms"] == pytest.approx(0.010)


@pytest.mark.parametrize("name,kind", [
    ("cudaStreamSynchronize", "sync_wait"), ("cudaDeviceSynchronize", "sync_wait"),
    ("cudaMemcpy", "sync_wait"), ("cudaLaunchKernel", "launch"),
    ("cudaMemsetAsync", "launch"), ("cudaMemcpyAsync", "launch"),
    ("cudaMalloc", "allocator"), ("cudaFree", "allocator"),
])
def test_runtime_call_classes(name, kind):
    assert tool().runtime_kind(name) == kind


def test_no_device_work_is_all_zero():
    got = tool().idle_breakdown([call("cudaLaunchKernel", 0, 5)])
    assert got["idle_ms"] == 0.0 and got["host_ms"] == 0.0
