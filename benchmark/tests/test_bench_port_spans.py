"""The readers of the port's own spans and counters (port_spans.py), on
synthetic `tool_main` spans whose info holds port records, its Wrap
around a real call of the port's Tool.main, and the tiny cells' traced
runs on the CPU, which read every metric of the port's."""
import importlib

import pytest

from benchmark import core, port_spans, tracing
from metacherchant_tpu_torch import trace as port_trace
from metacherchant_tpu_torch.tool import Tool


def rec(name, t0, t1, thread=1):
    return port_trace.SpanRecord(name, 0, None, 0, thread, t0, t1, 0.0)


def tool_main(job, spans, counters):
    s = tracing.Span("tool_main", job, 0.0, 100.0)
    s.info["port"] = {"spans": spans, "counters": counters}
    return s


def window(spans, jobs):
    return tracing.Trace(spans, jobs, 0.0, 100.0, None)


def metric(name):
    return importlib.import_module(f"benchmark.metrics.{name}")


@pytest.fixture
def jobs_of_three_genes():
    """Jobs 0 and 1 done, each with three gene threads that overlap; job 2
    failed (not in the window's jobs) and the warm-up (job None) ran
    before the window: neither counts."""
    def job(i, seed_s, fifo_s, probe):
        spans = [rec("count.parse", 0.0, 1.5), rec("count", 0.0, 2.0)]
        for t in (1, 2, 3):  # the same interval in each thread
            spans += [rec("env.seed", 2.0, 2.0 + seed_s, t),
                      rec("bfs.direction", 5.0, 5.0 + fifo_s / 2, t),
                      rec("bfs.direction", 6.0, 6.0 + fifo_s / 2, t)]
        return tool_main(i, spans, {"tables.probe": probe,
                                    "tables.fifo": 6,
                                    "extract.launches": 40})
    spans = [job(0, 1.0, 2.0, 3), job(1, 2.0, 4.0, 1),
             job(2, 50.0, 50.0, 9), job(None, 50.0, 50.0, 9),
             tracing.Span("count_kmers", 0, 0.0, 2.0)]
    return window(spans, [0, 1])


def test_span_seconds_sum_threads_per_job(jobs_of_three_genes):
    tr = jobs_of_three_genes
    # busy time: three threads of 1 s and of 2 s, over two jobs
    assert port_spans.span_seconds(tr, "env.seed") == pytest.approx(4.5)
    assert port_spans.span_seconds(tr, "bfs.direction") == pytest.approx(9.0)
    assert port_spans.span_seconds(tr, "count.parse") == pytest.approx(1.5)
    assert port_spans.span_seconds(tr, "dump") is None
    assert metric("seed_s").read(tr) == pytest.approx(4.5)
    assert metric("fifo_s").read(tr) == pytest.approx(9.0)
    assert metric("parse_s").read(tr) == pytest.approx(1.5)
    assert metric("dump_s").read(tr) is None


def test_counter_deltas_per_job(jobs_of_three_genes):
    tr = jobs_of_three_genes
    assert port_spans.counter_delta(tr, "tables.probe") == 2.0
    assert metric("table_builds").read(tr) == 8.0
    assert port_spans.counter_delta(tr, "extract.launches") == 40.0
    assert port_spans.counter_delta(tr, "no.such") == 0.0


def test_nothing_to_read_without_the_ports_records():
    """A port without the recorder (the hooks kept nothing), or a window
    whose jobs all failed: every reader returns None."""
    bare = tracing.Span("tool_main", 0, 0.0, 1.0)
    for tr in (window([bare], [0]),
               window([tool_main(0, [rec("dump", 0.0, 1.0)], {})], [])):
        assert port_spans.span_seconds(tr, "dump") is None
        assert port_spans.counter_delta(tr, "tables.fifo") is None
        for name in ("parse_s", "seed_s", "fifo_s", "table_builds",
                     "dump_s"):
            assert metric(name).read(tr) is None


def test_every_reader_lists_the_one_wrap():
    for name in ("parse_s", "seed_s", "fifo_s", "table_builds", "dump_s"):
        assert metric(name).WRAPS == (port_spans.TOOL_MAIN,)
    assert not port_spans.TOOL_MAIN.plain  # traced runs only


def test_wrap_records_a_call_of_tool_main(tmp_path):
    """Installed once for all five metrics, the Wrap records the port's
    spans of the call in its span's info, and leaves recording off."""
    class Steps(Tool):
        NAME = "steps"

        def run_impl(self):
            with port_trace.span("count.parse", bytes=7):
                port_trace.count("tables.fifo", 2)

    tracer = tracing.Tracer()
    tracer.install([w for name in ("parse_s", "seed_s", "fifo_s",
                                   "table_builds", "dump_s")
                    for w in metric(name).WRAPS])
    try:
        assert len(tracer._undo) == 1
        tracer.job = 0
        assert Steps().main(["-w", str(tmp_path / "wd")]) == 0
    finally:
        tracer.uninstall()
    assert port_trace._sinks is None and not port_spans._open
    (span,) = tracer.spans
    assert [(s.name, s.attrs) for s in span.info["port"]["spans"]] == [
        ("count.parse", {"bytes": 7}), ("tool", {"tool": "steps"})]
    assert span.info["port"]["counters"] == {"tables.fifo": 2}
    tr = window(tracer.spans, [0])
    assert metric("table_builds").read(tr) == 2
    assert 0 < metric("parse_s").read(tr) <= span.seconds


def test_a_call_that_raised_leaves_no_recording_open(tmp_path):
    class Raises(Tool):
        NAME = "raises"

        def run_impl(self):
            raise RuntimeError("not an ExecutionFailedException")

    class Ok(Tool):
        NAME = "ok"

        def run_impl(self):
            pass

    tracer = tracing.Tracer()
    tracer.install([port_spans.TOOL_MAIN])
    try:
        with pytest.raises(RuntimeError):
            Raises().main(["-w", str(tmp_path / "wd1")])
        assert port_trace._sinks is not None  # its after hook never ran
        assert Ok().main(["-w", str(tmp_path / "wd2")]) == 0
    finally:
        tracer.uninstall()
    assert port_trace._sinks is None and not port_spans._open
    raised, ok = tracer.spans
    assert "port" not in raised.info
    assert [s.attrs for s in ok.info["port"]["spans"]] == [{"tool": "ok"}]


#: the metrics that read the port, per tiny cell (conftest.TINY_CELLS)
PORT_METRICS = {"envfinder-tiny.genes3": {"parse_s", "seed_s", "fifo_s",
                                          "table_builds"},
                "fmt-tiny.count": {"parse_s", "dump_s"}}
#: the accepted metrics of each cell's traced run on a CPU
WRAPPER_METRICS = {"envfinder-tiny.genes3": {"count_s", "bfs_s",
                                             "picture_s"},
                   "fmt-tiny.count": {"count_s"}}


@pytest.mark.parametrize("cell", sorted(PORT_METRICS))
def test_tiny_cell_reads_the_port_metrics_traced(tiny_root, cell):
    """A traced run reports each metric of the port's that names the cell,
    beside the metrics the cell reported before, and stays correct."""
    run = core.Run(core.load_cell(tiny_root, cell), 2**31 + 5, 0.5, True,
                   device="cpu", scratch=str(tiny_root / "scratch"))
    try:
        res = run.execute()
    finally:
        run.cleanup()
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == PORT_METRICS[cell] | WRAPPER_METRICS[cell]
    assert all(m["value"] > 0 for k, m in res["metrics"].items()
               if k != "table_builds")
    if cell.startswith("env"):  # the BFS searches the sorted map: no table
        assert res["metrics"]["table_builds"]["value"] == 0
