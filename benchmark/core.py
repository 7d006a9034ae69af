"""The benchmark's harness: one run of one cell.

A cell of BENCHMARK.json names a configuration (its file under configs/)
and a traffic mix (traffic/<mix>.json). The configuration names its tool,
whose job launcher is jobs/<tool>.py and whose plain reference is
reference/<tool>.py; a tool that needs inputs besides the community's reads
and genes (mate files, a donor's dump) brings an input hook,
inputs/<tool>.py, that writes them from the seed (datagen.py says how); each
per-layer metric is metrics/<metric>.py. So a cell, a configuration, a mix,
a tool's inputs or a metric is added by adding files and entries, and this
file never learns their names.

A run: inputs from the seed (datagen.py, with the tool's input hook where
it has one), all made in set-up, one warm-up job, then the window,
a closed loop of one client that starts whole tool jobs through the port's
CLI entry (metacherchant_tpu_torch.runner.main, in this process) while less
than --seconds have passed, each into fresh directories; the last job runs
to its end and the window ends with it. A job reuses from earlier jobs only
what a fresh CLI process would also find: loaded code and libraries and the
build directory. Between jobs the harness collects garbage and empties
torch's cache of device memory, so no job starts with the last one's
blocks. After the window the reference works out what each job should have
written, from the same inputs, and the numbers it compares decide
`correct`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

#: top-level module names that no run may load (the JAX package's name is
#: a prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "metacherchant_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_file(path: Path, name: str):
    """A module of the benchmark found by its file name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module_name(kind: str, name: str) -> str:
    return "benchmark_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    launcher: object
    reference: object
    inputs: object | None  # the tool's input hook, where it has one
    end_to_end: list[dict]
    per_layer: list[tuple[dict, object]]


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json with everything it names,
    found under root/benchmark by name."""
    root = Path(root)
    spec = load_spec(root)
    bench = root / "benchmark"
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as fh:
        cfg = json.load(fh)
    with open(bench / "traffic" / f"{w['traffic']}.json") as fh:
        mix = json.load(fh)
    tool = cfg["tool"]
    hook = bench / "inputs" / f"{tool}.py"
    per_layer = [(m, load_file(bench / "metrics" / f"{m['name']}.py",
                               _module_name("metric", m["name"])))
                 for m in spec["per_layer"] if _applies(m, name)]
    return Cell(
        name=name, chips=int(w["chips"]), cfg=cfg, mix=mix,
        launcher=load_file(bench / "jobs" / f"{tool}.py",
                         _module_name("job", tool)),
        reference=load_file(bench / "reference" / f"{tool}.py",
                            _module_name("reference", tool)),
        inputs=(load_file(hook, _module_name("inputs", tool))
                if hook.exists() else None),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=per_layer)


@dataclass
class Job:
    index: int
    reads: str
    genes: str | None
    out_dir: str
    work_dir: str
    files: dict[str, str] = field(default_factory=dict)  # the hook's
    ok: bool = False
    seconds: float = 0.0
    error: str = ""


def run_window(seconds: float, make_job: Callable[[int], Job],
               run: Callable[[Job], None]) -> tuple[list[Job], float, float]:
    """The closed loop: start a job while less than `seconds` have passed
    (at least one); the last one runs to its end. Returns the jobs and the window's ends on
    the perf_counter clock."""
    jobs: list[Job] = []
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() - t0 < seconds:
        job = make_job(len(jobs))
        run(job)
        jobs.append(job)
    return jobs, t0, time.perf_counter()


class HostPeak:
    """The process's peak resident size over an interval, sampled from
    /proc/self/statm every `period` seconds by a thread (the kernel's own
    high-water mark cannot be reset where /proc/self/clear_refs is not
    writable, and would hold the set-up's peak)."""

    def __init__(self, period: float = 0.01):
        self.period = period
        self.peak = 0
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _rss(self) -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self._page

    def _sample(self) -> None:
        while True:
            self.peak = max(self.peak, self._rss())
            if self._stop.wait(self.period):
                return

    def __enter__(self) -> "HostPeak":
        self.peak = self._rss()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _tree_bytes(path: str) -> int:
    """Bytes of the files under `path`: what the run wrote there."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def card_facts() -> dict:
    """The card's name and power limit from nvidia-smi (empty where it
    cannot be read)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        name, limit = res.stdout.strip().splitlines()[0].rsplit(",", 1)
        return {"smi_name": name.strip(), "power_limit_w": float(limit)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def hook_files(inputs) -> dict:
    """The keyword that hands a reference the input hook's files: none for
    a tool without a hook, whose reference takes no such argument."""
    return {"files": inputs.files} if inputs.files else {}


def compare_all(ref, pairs) -> dict:
    """Each number of reference module `ref` summed over (expected, got)
    pairs, beside its limit."""
    total = dict.fromkeys(ref.LIMITS, 0)
    for want, got in pairs:
        for k, v in ref.compare(want, got).items():
            total[k] += v
    return {k: {"value": total[k], "limit": ref.LIMITS[k]}
            for k in ref.LIMITS}


class Run:
    """One run of a cell; `device` is 'cuda' from the command line, 'cpu'
    only in the tests that drive a run without a card."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", scratch: str | None = None):
        self.cell, self.seed = cell, seed
        self.seconds, self.trace, self.device = seconds, trace, device
        self.scratch = scratch
        self.notes: list[str] = []

    def say(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", flush=True)

    def _job(self, index: int, inputs) -> Job:
        """Window job `index` (-1: the warm-up), with the genes of slot
        index + 1 and the input hook's files, in fresh directories."""
        base = os.path.join(self.scratch, "jobs", f"job{index + 1}")
        return Job(index, inputs.reads, inputs.genes_of(index + 1),
                   os.path.join(base, "out"), os.path.join(base, "wd"),
                   inputs.files)

    def _between_jobs(self) -> None:
        import torch
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def _run_job(self, job: Job) -> None:
        t0 = time.perf_counter()
        try:
            rc = self.port_main(self.cell.launcher.argv(self.cell.cfg, job))
            job.ok, job.error = rc == 0, ("" if rc == 0 else f"exit {rc}")
        except Exception:
            job.ok, job.error = False, traceback.format_exc()
        job.seconds = time.perf_counter() - t0

    def execute(self) -> dict:
        """Set up, warm up, run the window, judge it; the result line."""
        import torch
        from benchmark import datagen, tracing
        os.environ["MC_PLATFORM"] = self.device
        cuda = self.device == "cuda"
        facts = card_facts() if cuda else {}
        from metacherchant_tpu_torch.runner import main as port_main
        self.port_main = port_main
        if self.scratch is None:
            self.scratch = tempfile.mkdtemp(prefix="mc-bench-")
        data_dir = os.path.join(self.scratch, "data")
        os.makedirs(data_dir, exist_ok=True)
        t = time.perf_counter()
        inputs = datagen.make_inputs(self.cell.cfg, self.cell.mix, self.seed,
                                     data_dir, self.device, self.cell.inputs)
        self.say(f"inputs from seed {self.seed} in "
                 f"{time.perf_counter() - t:.3f} s: "
                 f"{os.path.getsize(inputs.reads)} bytes of reads")
        # the warm-up: the same tool on the first quarter of the reads
        # brings every library and kernel of the path into the process
        warm = self._job(-1, inputs)
        warm.reads, warm.files = inputs.warm_reads, inputs.warm_files
        self._between_jobs()
        self._run_job(warm)
        if not warm.ok:
            raise RuntimeError(f"the warm-up job failed: {warm.error}")
        self.say(f"warm-up job {warm.seconds:.3f} s")

        # a traced run wraps everything its metrics read; every other run
        # only the plain host spans, for the per-job split it prints
        tracer = tracing.Tracer()
        wraps = [w for _, mod in self.cell.per_layer for w in mod.WRAPS]
        tracer.install(wraps if self.trace else
                       [w for w in wraps if w.plain])
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = process_age_s()

        def make_job(i: int) -> Job:
            tracer.job = i
            return self._job(i, inputs)

        def run(job: Job) -> None:
            self._between_jobs()
            span = tracer.job_span(job.index) if self.trace else None
            self._run_job(job)
            if span is not None:
                span.t1 = time.perf_counter()

        trace_file = os.path.join(self.scratch, "trace.json")
        if self.trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            with HostPeak() as host, profile(activities=acts) as prof:
                with record_function(tracing.WINDOW_MARK):
                    jobs, t0, t1 = run_window(self.seconds, make_job, run)
                if cuda:
                    torch.cuda.synchronize()
            prof.export_chrome_trace(trace_file)
        else:
            with HostPeak() as host:
                jobs, t0, t1 = run_window(self.seconds, make_job, run)
                if cuda:
                    torch.cuda.synchronize()
        peak_dev = torch.cuda.max_memory_allocated() if cuda else None
        peak_host = host.peak
        tracer.uninstall()
        window_s = t1 - t0
        done = [j for j in jobs if j.ok]
        for j in jobs:
            if not j.ok:
                self.notes.append(f"job {j.index} failed: {j.error.strip()}")
        self.say(f"window {window_s:.3f} s, {len(jobs)} jobs "
                 f"({', '.join(f'{j.seconds:.3f}' for j in jobs)} s)")
        for j in jobs:
            self.say(f"job {j.index}: {j.seconds:.3f} s; "
                     + tracing.job_split(tracer.spans, j.index))

        metrics: dict[str, dict] = {}
        breakdown = None
        device = {"platform": "gpu" if cuda else "cpu",
                  "count": self.cell.chips}
        if cuda:
            device.update(kind=torch.cuda.get_device_name(0),
                          memory_peak_bytes=int(peak_dev), **facts)
        if not self.trace:
            values = {
                "job_s": window_s / max(len(done), 1),
                "setup_s": setup_s,
                "peak_host_gib": peak_host / 2**30,
                "peak_dev_gib": (None if peak_dev is None
                                 else peak_dev / 2**30)}
            for m in self.cell.end_to_end:
                if values.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        else:
            tracer.resolve_events()
            self.notes.extend(tracer.notes)
            dev = tracing.device_intervals(trace_file, t0) if cuda else None
            if dev is None:
                self.notes.append("the profiler's trace holds no device "
                                  "work; device metrics left out")
            tr = tracing.Trace(tracer.spans, [j.index for j in done], t0, t1,
                               dev)
            for m, mod in self.cell.per_layer:
                try:
                    value = mod.read(tr)
                except Exception as e:
                    self.notes.append(f"metric {m['name']}: reader failed: "
                                      f"{e!r}")
                    value = None
                if value is None:
                    self.notes.append(f"metric {m['name']}: nothing to read "
                                      f"in this run; left out")
                    continue
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if tr.busy_s is not None:
                device.update(busy_s=tr.busy_s, window_s=tr.window_s)
                breakdown = tr.breakdown()
            if os.path.exists(trace_file):
                os.remove(trace_file)

        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        compared = self.judge(done, inputs)
        self.say(f"reference and comparison {time.perf_counter() - t:.3f} s")
        correct = len(done) == len(jobs) and all(
            v["value"] <= v["limit"] for v in compared.values())
        self.notes.append(f"this run wrote {_tree_bytes(self.scratch)} "
                          f"bytes of files under {self.scratch}")
        result = {"correct": correct, "attempted": len(jobs),
                  "failed": len(jobs) - len(done), "metrics": metrics,
                  "device": device}
        if breakdown:
            result["breakdown"] = breakdown
        result["compared"] = compared
        return result

    def judge(self, jobs: list[Job], inputs) -> dict:
        """Every completed window job against the reference: each number
        summed over the jobs, beside its limit."""
        import torch
        ref = self.cell.reference
        want = ref.solve(self.cell.cfg, inputs.reads, [j.genes for j in jobs],
                         torch.device(self.device), **hook_files(inputs))
        return compare_all(ref, [(w, ref.read_outputs(self.cell.cfg, j))
                                 for j, w in zip(jobs, want)])

    def cleanup(self) -> None:
        if self.scratch and os.path.isdir(self.scratch):
            shutil.rmtree(self.scratch, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    cell = load_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; no result", file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace))
    try:
        result = run.execute()
    finally:
        run.cleanup()
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules that no run may load are loaded: {', '.join(bad)}; "
              f"no result", file=sys.stderr)
        return 3
    for note in run.notes:
        print(note, file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
