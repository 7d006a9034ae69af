"""The port's spans and counters (metacherchant_tpu_torch/trace.py).

environment-finder (3 genes in 3 threads) and kmer-counter run through
runner.main on the CPU, on a small synthetic metagenome, inside a
recording: every span of every layer chains up to its job's one `tool`
root, the gene threads' spans included; the table counters agree with
the spans, and the launch spans' windows with the reads (the launch counter
stays put on the CPU); the files are the same with recording on and off,
and the writers' spans hold their bytes.
With recording off, span() is the shared no-op. A port span lies inside
the benchmark's wrapper span of the same call (one clock), and under
torch.profiler each port span is a user annotation of the chrome trace.
"""
import json
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from metacherchant_tpu_torch import trace
from metacherchant_tpu_torch.runner import main as port_main

ROOT = Path(__file__).resolve().parents[1]

#: the spans each tool's job opens (below its `tool` root)
ENV_SPANS = {"count", "count.parse", "count.launch", "count.consolidate",
             "count.finalize", "env.gene", "env.seed", "bfs.direction",
             "env.normalize", "env.extend", "picture", "picture.contract",
             "write.graph_txt", "write.seqs_fasta", "write.gfa", "write.tsvs"}
COUNTER_SPANS = {"count", "count.parse", "count.launch", "count.consolidate",
                 "count.finalize", "dump"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """2,000 reads of 80 bp from a 6 kbp genome and three genes of it."""
    tmp = tmp_path_factory.mktemp("trace_inputs")
    rng = np.random.default_rng(17)
    g = "".join(rng.choice(list("ACGT"), size=6000))
    (tmp / "reads.fastq").write_text("".join(
        f"@r{i}\n{g[s:s + 80]}\n+\n{'I' * 80}\n"
        for i, s in enumerate(rng.integers(0, 5920, size=2000))))
    (tmp / "genes.fasta").write_text("".join(
        f">gene{c}\n{g[lo:lo + 150]}\n"
        for c, lo in zip("ABC", (800, 2500, 4400))))
    return tmp


def _argv(tool: str, inputs: Path, out: Path) -> list[str]:
    if tool == "environment-finder":
        return ["-t", tool, "-k", "21", "-i", str(inputs / "reads.fastq"),
                "--seq", str(inputs / "genes.fasta"), "-o", str(out / "out"),
                "--coverage", "3", "--maxradius", "100", "-p", "3",
                "--work-dir", str(out / "wd")]
    return ["-t", tool, "-k", "21", "-i", str(inputs / "reads.fastq"),
            "-o", str(out / "out"), "--work-dir", str(out / "wd")]


def _tree(path: Path) -> dict[str, bytes]:
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def jobs(inputs, tmp_path_factory):
    """Each tool's job once with recording on (its recording) and once off
    (no recording), and the files of both."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MC_PLATFORM", "cpu")
    out = {}
    try:
        for tool in ("environment-finder", "kmer-counter"):
            on = tmp_path_factory.mktemp(f"{tool}_on")
            off = tmp_path_factory.mktemp(f"{tool}_off")
            with trace.recording() as rec:
                assert port_main(_argv(tool, inputs, on)) == 0
            assert port_main(_argv(tool, inputs, off)) == 0
            out[tool] = (rec, _tree(on / "out"), _tree(off / "out"))
    finally:
        mp.undo()
    return out


def _names(rec) -> list[str]:
    return [s.name for s in rec.spans]


@pytest.mark.parametrize("tool,want", [("environment-finder", ENV_SPANS),
                                       ("kmer-counter", COUNTER_SPANS)])
def test_every_span_chains_to_one_tool_root(jobs, tool, want):
    rec = jobs[tool][0]
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.name == "tool"]
    assert len(roots) == 1 and roots[0].parent is None
    root = roots[0]
    assert root.attrs == {"tool": tool}
    assert set(_names(rec)) == want | {"tool"}
    for s in rec.spans:
        assert s.root == root.id
        chain = s
        while chain.parent is not None:
            parent = by_id[chain.parent]
            assert parent.t0 <= chain.t0 <= chain.t1 <= parent.t1
            chain = parent
        assert chain is root
        assert 0 <= s.cpu_s


def test_gene_threads_name_the_tool_span_as_parent(jobs):
    rec = jobs["environment-finder"][0]
    root = next(s for s in rec.spans if s.name == "tool")
    genes = [s for s in rec.spans if s.name == "env.gene"]
    assert len(genes) == 3
    assert all(g.parent == root.id and g.thread != root.thread
               for g in genes)
    by_id = {s.id: s for s in rec.spans}
    for name in ("env.seed", "bfs.direction", "picture"):
        for s in (s for s in rec.spans if s.name == name):
            assert by_id[s.parent].name == "env.gene"
            assert s.thread == by_id[s.parent].thread
    directions = [s for s in rec.spans if s.name == "bfs.direction"]
    assert sorted(s.attrs["direction"] for s in directions) == \
        [-1] * 3 + [1] * 3
    assert all(s.attrs["visited"] > 0 for s in directions)


#: the k-mer windows of the input: 2,000 reads of 80 bp at k = 21
WINDOWS = 2000 * (80 - 21 + 1)


@pytest.mark.parametrize("tool", ["environment-finder", "kmer-counter"])
def test_launch_counter_equals_launch_spans(jobs, tool):
    """On the CPU no launch reaches the kernel, so extract.launches stays
    put (tests/test_torch_cuda.py holds it to the spans on the card); the
    launch spans' windows are every k-mer window of the reads, once."""
    rec = jobs[tool][0]
    assert "extract.launches" not in rec.counters
    launches = [s for s in rec.spans if s.name == "count.launch"]
    assert len(launches) > 0
    assert all(s.attrs["windows"] > 0 and s.attrs["h2d_bytes"] > 0
               for s in launches)
    assert sum(s.attrs["windows"] for s in launches) == WINDOWS


def test_fifo_tables_equal_native_directions(jobs):
    """The native FIFO searches the map's sorted keys: no table of its own
    (no tables.fifo). get_many searches them too, so the job's one map
    builds no probe table."""
    rec = jobs["environment-finder"][0]
    native = [s for s in rec.spans if s.name == "bfs.direction"
              and s.attrs["engine"] == "native"]
    assert len(native) == 6
    assert "tables.fifo" not in rec.counters
    assert "tables.probe" not in rec.counters
    assert "kmap.probe_table" not in _names(rec)


@pytest.mark.parametrize("tool", ["environment-finder", "kmer-counter"])
def test_files_are_the_same_with_recording_on_and_off(jobs, tool):
    rec, on, off = jobs[tool]
    assert on and on == off
    writes = [s for s in rec.spans
              if s.name.startswith("write.") or s.name == "dump"]
    assert sum(s.attrs["bytes"] for s in writes) == sum(
        len(data) for data in on.values())


def test_off_span_is_the_shared_noop(monkeypatch):
    """No clock read, no profiler call, no allocation that lasts: the
    clocks and record_function raise if touched."""
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read with recording off")

    def no_profiler(name):
        raise AssertionError("record_function called with recording off")

    monkeypatch.setattr(trace, "time", NoClock())
    monkeypatch.setattr(trace, "_record_function", no_profiler)
    assert trace._sinks is None

    @trace.traced("off.decorated")
    def decorated(x):
        return x + 1

    assert trace.span("off") is trace.NO_SPAN
    assert trace.current() is trace.NO_SPAN
    tracemalloc.start()
    try:
        for _ in range(100):
            with trace.span("off") as sp:
                sp.set()
            decorated(1)
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for _ in range(20000):
            with trace.span("off") as sp:
                sp.set()
            decorated(1)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 20,000 calls: anything kept or allocated per call would show here
    assert now - base < 256 and peak - base < 1024
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_counters_are_always_on_and_recordings_nest():
    before = trace.counter("test.count")
    trace.count("test.count", 3)
    assert trace.counter("test.count") == before + 3
    with trace.recording() as outer:
        with trace.span("a", n=1):
            with trace.recording() as inner:
                with trace.span("b") as sp:
                    sp.set(m=2)
                    trace.count("test.count")
        with trace.span("c"):
            pass
    assert trace._sinks is None
    assert [s.name for s in outer.spans] == ["b", "a", "c"]
    assert [(s.name, s.attrs) for s in inner.spans] == [("b", {"m": 2})]
    a, b, c = (next(s for s in outer.spans if s.name == n) for n in "abc")
    assert b.parent == a.id and b.root == a.id == a.root
    assert c.parent is None and c.root == c.id
    assert outer.counters == inner.counters == {"test.count": 1}


def test_submitted_work_names_the_submitter_as_parent():
    def work():
        with trace.span("worker"):
            time.sleep(0.01)
        return threading.get_ident()

    with trace.recording() as rec, ThreadPoolExecutor(max_workers=4) as ex:
        with trace.span("submitter") as sub:
            futs = [trace.submit(ex, work) for _ in range(8)]
            idents = {f.result() for f in futs}
        plain = ex.submit(work).result()
    workers = [s for s in rec.spans if s.name == "worker"]
    assert len(workers) == 9 and threading.get_ident() not in idents
    assert [s.parent for s in workers[:8]] == [sub.id] * 8
    assert workers[8].parent is None and workers[8].thread == plain


def test_port_span_lies_inside_the_benchmarks_wrapper_span(inputs, tmp_path,
                                                           monkeypatch):
    """benchmark/tracing.py wraps a port function with the host clock; the
    port's own span of the same call lies inside it."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmark.tracing import Tracer, Wrap
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    tracer = Tracer()
    tracer.install([Wrap("metacherchant_tpu_torch.tools.kmer_counter",
                         "count_kmers", "count_kmers")])
    try:
        with trace.recording() as rec:
            assert port_main(_argv("kmer-counter", inputs, tmp_path)) == 0
    finally:
        tracer.uninstall()
    (outer,) = [s for s in tracer.spans if s.name == "count_kmers"]
    (inner,) = [s for s in rec.spans if s.name == "count"]
    assert outer.t0 <= inner.t0 < inner.t1 <= outer.t1
    assert inner.seconds > 0.5 * outer.seconds


def test_profiler_trace_holds_each_port_span(inputs, tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=trace.all_threads()) as prof, \
            trace.recording() as rec:
        assert port_main(_argv("environment-finder", inputs, tmp_path)) == 0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    for name in set(_names(rec)):
        assert marks.count(name) == _names(rec).count(name), name


#: the spans reads-classifier's job opens (below its `tool` root)
CLASSIFY_SPANS = {"classify.load", "classify.parse", "classify.find",
                  "classify.coverage", "write.bins"}
CLASSIFY_BINS = ("found_1", "found_2", "not_found_1", "not_found_2",
                 "found_s", "not_found_s")


class _NoSpanAllowed:
    def __init__(self, *args):
        raise AssertionError("a span was made with no recording open")


@pytest.fixture(scope="module")
def classified(inputs, tmp_path_factory):
    """kmer-counter -b 1 of the reads, then reads-classifier of the reads'
    two halves as mates against its dump, in batches of 256 pairs, on each
    route: the device route with three workers and the host route with
    one, each recorded, and unrecorded with span making forbidden."""
    from metacherchant_tpu_torch.tools import reads_classifier
    tmp = tmp_path_factory.mktemp("classified")
    lines = (inputs / "reads.fastq").read_text().splitlines(True)
    (tmp / "r1.fastq").write_text("".join(lines[:4000]))
    (tmp / "r2.fastq").write_text("".join(lines[4000:]))
    mp = pytest.MonkeyPatch()
    mp.setenv("MC_PLATFORM", "cpu")
    mp.setattr(reads_classifier, "CLASSIFY_BATCH", 256)
    runs = {}
    try:
        assert port_main(["-t", "kmer-counter", "-k", "21", "-b", "1",
                          "-i", str(inputs / "reads.fastq"),
                          "-o", str(tmp / "bin"),
                          "--work-dir", str(tmp / "wbin")]) == 0
        for route, flag, threads in (("device", "1", "3"),
                                     ("host", "", "1")):
            mp.setenv("MC_DEVICE_CLASSIFY", flag)
            mp.setenv("MC_CLASSIFY_THREADS", threads)
            out = {}
            for mode in ("on", "off"):
                argv = ["-t", "reads-classifier", "-k", "21",
                        "-i", str(tmp / "bin" / "reads.kmers.bin"),
                        "-r", str(tmp / "r1.fastq"), str(tmp / "r2.fastq"),
                        "-o", str(tmp / route / mode / "out"),
                        "--work-dir", str(tmp / route / mode / "wd")]
                if mode == "on":
                    with trace.recording() as rec:
                        assert port_main(argv) == 0
                else:
                    with pytest.MonkeyPatch.context() as off:
                        off.setattr(trace, "_Span", _NoSpanAllowed)
                        assert port_main(argv) == 0
                out[mode] = _tree(tmp / route / mode / "out")
            runs[route] = (rec, out["on"], out["off"])
    finally:
        mp.undo()
    return tmp, runs


@pytest.mark.parametrize("route", ["device", "host"])
def test_classifier_spans_chain_to_the_tool_root(classified, route):
    """Each batch's classify.find runs in a worker of the pool on the
    device route, under the job's `tool` span all the same; its child
    classify.coverage runs in the same thread."""
    rec = classified[1][route][0]
    (root,) = [s for s in rec.spans if s.name == "tool"]
    names = set(_names(rec)) - {"tool"}
    assert names == CLASSIFY_SPANS | ({"kmap.probe_table"}
                                      if route == "host" else set())
    assert all(s.root == root.id for s in rec.spans)
    by_id = {s.id: s for s in rec.spans}
    finds = [s for s in rec.spans if s.name == "classify.find"]
    assert len(finds) == 8  # 1,000 pairs in batches of 256, two mates
    assert all(s.parent == root.id for s in finds)
    assert all(s.attrs["engine"] == route for s in finds)
    if route == "device":
        assert all(s.thread != root.thread for s in finds)
    for s in rec.spans:
        if s.name == "classify.coverage":
            parent = by_id[s.parent]
            assert parent.name == "classify.find"
            assert s.thread == parent.thread
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
        elif s.name in ("classify.load", "classify.parse", "write.bins"):
            assert s.parent == root.id and s.thread == root.thread


@pytest.mark.parametrize("route", ["device", "host"])
def test_classifier_counts_add_up(classified, route):
    """The finds' reads and windows are the mates', once; the counters
    count them and the found reads the bins hold; the load and bin spans
    hold the bytes of the dump and the bins, the parses the pairs and bases
    of the mates, a batch pair at a time; the files
    are the same with recording on and off (with no span made)."""
    tmp, runs = classified
    rec, on, off = runs[route]
    assert on and on == off
    spans = {n: [s for s in rec.spans if s.name == n] for n in CLASSIFY_SPANS}
    finds = spans["classify.find"]
    assert sum(s.attrs["reads"] for s in finds) == 2000
    assert sum(s.attrs["windows"] for s in finds) == WINDOWS
    found = sum(on[f"{b}.fastq"].count(b"\n+\n")
                for b in ("found_1", "found_2", "found_s"))
    assert 0 < found < 2000
    assert rec.counters["classify.reads"] == 2000
    assert rec.counters["classify.found"] == found
    dump = (tmp / "bin" / "reads.kmers.bin").stat().st_size
    (load,) = spans["classify.load"]
    assert load.attrs == {"records": dump // 10, "bytes": dump,
                          "map_keys": dump // 10}
    # one parse a batch pair, 1,000 pairs in batches of 256, and the end
    parses = spans["classify.parse"]
    assert [s.attrs["reads"] for s in parses] == [256, 256, 256, 232, 0]
    assert sum(s.attrs["bases"] for s in parses) == sum(
        len(line.strip())
        for f in ("r1.fastq", "r2.fastq")
        for line in (tmp / f).read_text().splitlines()[1::4])
    bins = spans["write.bins"]
    assert len(bins) == 4
    assert sum(s.attrs["bytes"] for s in bins) == sum(
        len(on[f"{b}.fastq"]) for b in CLASSIFY_BINS)
