"""The closed loop, the span arithmetic and the device trace's reduction,
with stub jobs and a synthetic trace."""
import json
import time

import pytest

from benchmark import core, tracing


def test_window_counts_jobs_failures_and_time():
    def make_job(i):
        return core.Job(i, "reads", None, f"out{i}", f"wd{i}")

    def run(job):
        time.sleep(0.05)
        job.ok = job.index % 3 != 1  # every third job fails

    jobs, t0, t1 = core.run_window(0.3, make_job, run)
    # jobs start while less than 0.3 s have passed; the last runs to its end
    assert [j.index for j in jobs] == list(range(len(jobs)))
    assert 6 <= len(jobs) <= 7
    assert t1 - t0 >= 0.3 and t1 - t0 < 0.3 + 0.05 + 0.1
    assert sum(not j.ok for j in jobs) == len(range(1, len(jobs), 3))


def test_window_runs_at_least_one_job():
    jobs, t0, t1 = core.run_window(1e-9, lambda i: core.Job(
        i, "r", None, "o", "w"), lambda j: None)
    assert len(jobs) == 1


def test_tracer_wraps_and_restores(monkeypatch):
    import types
    mod = types.ModuleType("bench_stub")

    class Counter:
        def step(self, n):
            return n + 1

    mod.Counter, mod.work = Counter, (lambda x: x * 2)
    monkeypatch.setitem(__import__("sys").modules, "bench_stub", mod)
    tr = tracing.Tracer()
    tr.install([
        tracing.Wrap("bench_stub", "work", "work",
                     before=lambda a, k: {"x": a[0]}),
        tracing.Wrap("bench_stub", "Counter.step", "step",
                     after=lambda info, a, k, r: info.update(out=r)),
        tracing.Wrap("bench_stub", "gone", "gone"),
        tracing.Wrap("bench_stub", "work", "bad",
                     before=lambda a, k: 1 / 0)])
    assert [n for n in tr.notes if "gone" in n] == [
        "span gone: bench_stub.gone not found in the port; not installed"]
    tr.job = 4
    assert mod.work(3) == 6 and Counter().step(1) == 2
    assert [(s.name, s.job, s.info) for s in tr.spans] == [
        ("work", 4, {"x": 3}), ("bad", 4, {}), ("step", 4, {"out": 2})]
    assert any("hook failed" in n for n in tr.notes)
    tr.uninstall()
    assert mod.work is not None and len(tr.spans) == 3
    mod.work(1)
    Counter().step(1)
    assert len(tr.spans) == 3


def _trace():
    spans = [tracing.Span("job", 0, 0.0, 4.0), tracing.Span("job", 1, 5.0, 9.0),
             tracing.Span("count_kmers", 0, 0.5, 2.0),
             tracing.Span("count_kmers", 1, 5.5, 6.5),
             tracing.Span("build_environment", 1, 6.5, 8.5),
             tracing.Span("build_environment", 1, 6.5, 7.5),
             tracing.Span("count_kmers", None, -3.0, -2.0)]  # the warm-up
    device = [("extract_kernel", 1.0, 1.5), ("sort", 1.25, 1.75),
              ("memcpy", 6.0, 6.25), ("late", 9.5, 12.0)]
    return tracing.Trace(spans, [0, 1], 0.0, 10.0, device)


def test_trace_sums_spans_per_job_and_the_busy_union():
    tr = _trace()
    assert tr.mean_per_job("count_kmers") == pytest.approx((1.5 + 1.0) / 2)
    assert tr.mean_per_job("build_environment") == pytest.approx(3.0 / 2)
    assert tr.mean_per_job("create_picture") is None
    assert tr.busy == [(1.0, 1.75), (6.0, 6.25), (9.5, 10.0)]
    assert tr.busy_s == pytest.approx(1.5)
    assert [k[0] for k in tr.kernels("extract")] == ["extract_kernel"]


def test_breakdown_names_ops_and_gaps():
    bd = _trace().breakdown()
    assert bd["device_ops"][0] == ["extract_kernel", 0.5]
    gaps = bd["idle_gaps"]
    assert gaps == [  # 1.75-6.0, 6.25-9.5, 0.0-1.0
        ["job 0: count_kmers -> job 0: job -> job 1: count_kmers",
         pytest.approx(4.25)],
        ["job 1: count_kmers -> job 1: build_environment -> between jobs",
         pytest.approx(3.25)],
        ["job 0: job -> job 0: count_kmers", pytest.approx(1.0)]]


def test_device_intervals_align_on_the_window_mark(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW_MARK,
         "ts": 1000.0, "dur": 2e6},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1500.0, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 3000.0,
         "dur": 1000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 0, "dur": 5}]}))
    dev = tracing.device_intervals(str(path), t0=100.0)
    assert dev[0] == ("k1", pytest.approx(100.0005), pytest.approx(100.00051))
    assert dev[1][1:] == (pytest.approx(100.002), pytest.approx(100.003))
    (tmp_path / "empty.json").write_text(json.dumps({"traceEvents": []}))
    assert tracing.device_intervals(str(tmp_path / "empty.json"), 0.0) is None


def test_process_age_and_forbidden_names():
    assert 0 < core.process_age_s() < 3600 * 24
    assert core.forbidden_modules(
        ["metacherchant_tpu_torch", "metacherchant_tpu_torch.ops", "numpy",
         "jaxtyping", "metacherchant_tpu", "jax.numpy", "flax", "jaxlib"]) \
        == ["flax", "jax.numpy", "jaxlib", "metacherchant_tpu"]


def test_host_peak_sees_a_short_allocation():
    import numpy as np
    with core.HostPeak(period=0.005) as peak:
        base = peak.peak
        block = np.ones(200 * 2**20 // 8)
        time.sleep(0.05)
        del block
    assert peak.peak - base >= 190 * 2**20
