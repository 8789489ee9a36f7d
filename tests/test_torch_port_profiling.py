"""``maskrcnn_tf2_tpu_torch/utils/profiling.py`` against the JAX package's
``utils/profiling.py``, on the CPU.

``top_ops`` of both read the same Chrome traces to the same list, exactly
(names, summed microseconds and order), with ``device_only=False``: with
``device_only=True`` JAX keeps a TPU process's events and the port the CUDA
activity's (kernels, copies, memsets). ``trace`` profiles a small CPU
forward, whose ops are ``aten::`` ops and which has no device events.
"""

import gzip
import json
import os

import pytest
import torch

from maskrcnn_tf2_tpu.utils import profiling as jax_profiling

from maskrcnn_tf2_tpu_torch.utils import profiling


def _write_trace(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _handcrafted(tmp_path):
    """Two traces, one in a subdirectory: CPU ops, CUDA kernels, a copy and a
    memset on a device stream, a TPU process's ops, flow and metadata events
    and an "X" event without a duration; names repeat across files and
    processes, and two totals tie."""
    meta = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python3"}},
            {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/device:TPU:0"}},
            {"ph": "M", "name": "process_name", "pid": 3, "args": {"name": "GPU 0"}}]
    first = meta + [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1, "tid": 1, "ts": 0, "dur": 120.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1, "ts": 130, "dur": 7.25},
        {"ph": "X", "cat": "kernel", "name": "nms_mask_kernel(float const*, int)", "pid": 3, "tid": 7,
         "ts": 5, "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "void roi_align_kernel<__nv_bfloat16, 8>(Args)", "pid": 3,
         "tid": 7, "ts": 50, "dur": 18.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 3, "tid": 8,
         "ts": 1, "dur": 3.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 3, "tid": 8, "ts": 2, "dur": 1.5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 4, "dur": 5.0},
        {"ph": "X", "name": "fusion.12", "pid": 2, "tid": 1, "ts": 0, "dur": 18.0},
        {"ph": "X", "name": "no duration", "pid": 1, "tid": 1, "ts": 0},
        {"ph": "s", "cat": "ac2g", "name": "flow", "pid": 1, "tid": 1, "ts": 4, "id": 1},
        {"ph": "i", "name": "instant", "pid": 1, "tid": 1, "ts": 9, "dur": 99.0},
    ]
    second = meta + [
        {"ph": "X", "cat": "kernel", "name": "nms_mask_kernel(float const*, int)", "pid": 3, "tid": 7,
         "ts": 500, "dur": 2.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1, "ts": 400, "dur": 0.75},
        {"ph": "X", "name": "fusion.12", "pid": 2, "tid": 1, "ts": 10, "dur": 0.0},
    ]
    _write_trace(tmp_path / "host_1.trace.json.gz", first)
    _write_trace(tmp_path / "plugins" / "profile" / "host_2.trace.json.gz", second)
    (tmp_path / "ignored.json").write_text(json.dumps({"traceEvents": first}))
    return tmp_path


@pytest.mark.parametrize("k", [25, 3, 1])
def test_top_ops_matches_jax_on_handcrafted_traces(tmp_path, k):
    trace_dir = str(_handcrafted(tmp_path))
    ours = profiling.top_ops(trace_dir, k=k, device_only=False)
    assert ours == jax_profiling.top_ops(trace_dir, k=k, device_only=False)
    assert ours[0] == ("aten::conv2d", 120.5) and len(ours) == min(k, 8)


def test_top_ops_device_only_keeps_the_cuda_activity(tmp_path):
    trace_dir = str(_handcrafted(tmp_path))
    assert profiling.top_ops(trace_dir, device_only=True) == [
        ("nms_mask_kernel(float const*, int)", 42.5),
        ("void roi_align_kernel<__nv_bfloat16, 8>(Args)", 18.0),
        ("Memcpy HtoD (Pageable -> Device)", 3.0),
        ("Memset (Device)", 1.5),
    ]
    assert jax_profiling.top_ops(trace_dir, device_only=True) == [("fusion.12", 18.0)]


def test_trace_of_a_cpu_forward(tmp_path, capsys):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(), torch.nn.Conv2d(8, 4, 1))
    x = torch.randn(2, 3, 16, 16)
    with torch.no_grad():
        trace_dir = profiling.trace(lambda: model(x), str(tmp_path / "given"))
    assert trace_dir == str(tmp_path / "given")
    assert [f for f in os.listdir(trace_dir) if f.endswith(".trace.json.gz")]
    ops = profiling.top_ops(trace_dir, k=1000, device_only=False)
    names = [name for name, _ in ops]
    assert "aten::conv2d" in names and "aten::relu" in names
    assert all(us >= 0 for _, us in ops) and ops == sorted(ops, key=lambda kv: -kv[1])
    assert ops == jax_profiling.top_ops(trace_dir, k=1000, device_only=False)
    assert profiling.top_ops(trace_dir, device_only=True) == []
    profiling.print_top_ops(trace_dir, k=5)
    assert capsys.readouterr().out == ""  # no device events on the CPU

    default_dir = profiling.trace(lambda: model(x))
    try:
        assert os.path.basename(default_dir).startswith("mrcnn_trace_")
        assert "aten::conv2d" in [name for name, _ in profiling.top_ops(default_dir, device_only=False)]
    finally:
        for f in os.listdir(default_dir):
            os.remove(os.path.join(default_dir, f))
        os.rmdir(default_dir)
