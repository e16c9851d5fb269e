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


@pytest.mark.parametrize("name", [
    "void syevbj_batch_32x16<float, float>(long, int const*, int const*)",
    "void column_rotate_batch<float, 5, 3>(long, int const*, int const*)",
    "void row_rotate_batch_32x16_phase1<float>(long, int const*)",
    "void sytrd4_gpu<sytrd_params<double, 32, 8, 512, 32, 16, 1, 2> >(int)"])
def test_eigh_kernels_count_as_cusolver(name):
    # the Jacobi kernels cuSOLVER runs for float32 eigh (the fp32 Gamma
    # path's Rayleigh-Ritz) are eigh time, as the tridiagonal ones are
    assert tool().category(name) == "cusolver eigh"


def test_range_launches_count_the_potentials_device_work():
    # two annotated potentials: the launches inside them and the device
    # operations those started (by correlation id); launches outside the
    # ranges and non-launch calls do not count
    def launch(name, ts, corr):
        return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def op(name, cat, corr):
        return {"cat": cat, "name": name, "ts": 100, "dur": 1,
                "args": {"correlation": corr}}

    rng = {"cat": "user_annotation", "name": "generate_potential"}
    events = [dict(rng, ts=0, dur=10), dict(rng, ts=20, dur=10),
              launch("cudaLaunchKernel", 2, 1), launch("cudaMemsetAsync", 4, 2),
              launch("cudaLaunchKernelExC", 22, 3),
              launch("cudaLaunchKernel", 15, 4),
              launch("cudaStreamSynchronize", 25, 5),
              op("xc_inputs_kernel", "kernel", 1), op("Memset", "gpu_memset", 2),
              op("xc_inputs_kernel", "kernel", 3), op("other", "kernel", 4)]
    got = tool().range_launches(events, "generate_potential")
    assert got["ranges"] == 2 and got["launch_calls"] == 3
    assert got["device_ops"] == 3
    assert got["device_ops_by_name"] == {"xc_inputs_kernel": 2, "Memset": 1}
    assert tool().category("xc_inputs_kernel") == "hand kernels"
