"""The trace reduction, on host events (the CPU has no device ones)."""

import torch

from benchmark import tracing


def test_the_window_runs_between_its_marks_and_labels_idle_time():
    with tracing.Window(lambda: None) as window:
        a = torch.randn(64, 64)
        for _ in range(3):
            a = a @ a
    trace = window.trace
    assert trace.window_s > 0 and trace.busy_s == 0
    assert any(name == "aten::mm" for name, _, _ in trace.host)
    out = trace.breakdown()
    assert out["device_ops"] == []
    assert sum(s for _, s in out["idle_gaps"]) == \
        __import__("pytest").approx(trace.window_s)


def test_union_and_gaps_of_device_intervals():
    trace = tracing.Trace(1.0, [("k1", 0.1, 0.3), ("k2", 0.2, 0.4),
                                ("nccl", 0.6, 0.7)],
                          [("aten::mm", 0.0, 0.5)])
    assert abs(trace.busy_s - 0.4) < 1e-12
    assert [tuple(round(x, 6) for x in g) for g in trace.idle_gaps()] == [
        (0.0, 0.1), (0.4, 0.6), (0.7, 1.0)]
    assert abs(trace.seconds(("k",)) - 0.4) < 1e-12
    assert trace.host_label(0.45) == "aten::mm"
    assert trace.host_label(0.8) == "host between operations"


def test_short_names_drop_arguments_and_templates():
    assert tracing.short_name(
        "void flash_fwd_kernel<128, true>(bf16 const*, int)") == \
        "flash_fwd_kernel<128, true>"
    assert tracing.short_name(
        "void (anonymous namespace)::flash_dq_kernel<128>(float const*)") == \
        "flash_dq_kernel<128>"
