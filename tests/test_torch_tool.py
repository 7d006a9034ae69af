"""The port's Tool lifecycle against the JAX package's.

The six framework tests of tests/test_tool_framework.py on the port's Tool
(out.properties written and reloaded, steps with SUCCESS.<step> markers,
--start/--finish bounds, mid-pipeline resume); then every one of the eleven
tools run on one small case in both packages, their workDirs compared: the
file names (timestamped log files masked), the SUCCESS markers,
out.properties, and in.properties with the run's root path masked.
"""
import json
import os
import re

import numpy as np
import pytest

from metacherchant_tpu.runner import _TOOL_MODULES
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.runner import main as port_main
from metacherchant_tpu_torch.tool import (ExecutionFailedException, Parameter,
                                          Tool)

from metacherchant_tpu_torch import counting
from test_torch_assembler import SPADES_STUB, jax_host_main


class OutTool(Tool):
    NAME = "out-tool"

    def __init__(self):
        super().__init__()
        self.x = self.add_parameter(Parameter("x", int, default=1))
        self.ran = 0

    def run_impl(self):
        self.ran += 1
        self.add_output("answer", self.x.get(self) * 2)
        self.add_output("resultPath", "graph.txt")


class StepTool(Tool):
    NAME = "step-tool"

    def __init__(self):
        super().__init__()
        self.trace: list[str] = []
        for name in ("alpha", "beta", "gamma"):
            self.add_step(name, lambda n=name: self.trace.append(n))


def test_out_properties_written_and_reloaded_on_skip(tmp_path):
    wd = str(tmp_path / "wd")
    t = OutTool()
    assert t.main(["-w", wd, "--x", "21"]) == 0
    assert t.ran == 1
    out = open(os.path.join(wd, "out.properties")).read()
    assert out == "tool=out-tool\nanswer=42\nresultPath=graph.txt\n"

    t2 = OutTool()
    assert t2.main(["-w", wd, "--x", "21", "--continue"]) == 0
    assert t2.ran == 0
    assert t2.get_output("answer") == "42"
    assert t2.get_output("resultPath") == "graph.txt"

    t3 = OutTool()
    assert t3.main(["-w", wd, "--x", "5", "--continue"]) == 0
    assert t3.ran == 1
    assert t3.get_output("answer") == "10"


def test_steps_run_in_order_with_markers(tmp_path):
    wd = str(tmp_path / "wd")
    t = StepTool()
    assert t.main(["-w", wd]) == 0
    assert t.trace == ["alpha", "beta", "gamma"]
    for n in ("alpha", "beta", "gamma"):
        assert os.path.exists(os.path.join(wd, f"SUCCESS.{n}"))
    assert os.path.exists(os.path.join(wd, "SUCCESS"))
    assert open(os.path.join(wd, "out.properties")).read() == \
        "tool=step-tool\n"


def test_start_finish_bounds(tmp_path):
    wd = str(tmp_path / "wd")
    t = StepTool()
    assert t.main(["-w", wd, "--start", "beta", "--finish", "beta"]) == 0
    assert t.trace == ["beta"]
    assert not os.path.exists(os.path.join(wd, "SUCCESS"))
    assert os.path.exists(os.path.join(wd, "SUCCESS.beta"))

    t2 = StepTool()
    assert t2.main(["-w", wd, "--continue"]) == 0
    assert t2.trace == ["alpha", "gamma"]
    assert os.path.exists(os.path.join(wd, "SUCCESS"))


def test_unknown_stage_is_an_error(tmp_path):
    wd = str(tmp_path / "wd")
    t = StepTool()
    assert t.main(["-w", wd, "--start", "nope"]) == 1
    assert t.trace == []
    assert "Unknown stage for --start: 'nope' (stages: alpha, beta, gamma)" \
        in open(os.path.join(wd, "log")).read()
    t2 = StepTool()
    assert t2.main(["-w", wd, "--start", "gamma", "--finish", "alpha"]) == 1
    assert t2.trace == []


def test_single_stage_start_finish_validation(tmp_path):
    wd = str(tmp_path / "wd")
    t = OutTool()
    assert t.main(["-w", wd, "--start", "bogus"]) == 1
    assert "Unknown stage for --start: 'bogus' (stages: out-tool)" \
        in open(os.path.join(wd, "log")).read()
    t2 = OutTool()
    assert t2.main(["-w", wd, "--start", "out-tool", "--finish",
                    "out-tool"]) == 0
    assert t2.ran == 1


def test_mid_pipeline_resume(tmp_path):
    wd = str(tmp_path / "wd")

    class Flaky(StepTool):
        def __init__(self, explode: bool):
            super().__init__()
            if explode:
                self._steps[1] = (
                    "beta",
                    lambda: (_ for _ in ()).throw(
                        ExecutionFailedException("boom")))

    t = Flaky(True)
    assert t.main(["-w", wd]) == 1
    assert t.trace == ["alpha"]
    assert os.path.exists(os.path.join(wd, "SUCCESS.alpha"))
    assert not os.path.exists(os.path.join(wd, "SUCCESS"))
    assert not os.path.exists(os.path.join(wd, "out.properties"))

    t2 = Flaky(False)
    assert t2.main(["-w", wd, "--continue"]) == 0
    assert t2.trace == ["beta", "gamma"]
    assert os.path.exists(os.path.join(wd, "SUCCESS"))


def _annotations(path) -> list[str]:
    """The user annotations (record_function ranges) of a chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_profile_wraps_every_step(tmp_path):
    wd = str(tmp_path / "wd")
    t = StepTool()
    assert t.main(["-w", wd, "--profile", str(tmp_path / "prof")]) == 0
    assert t.trace == ["alpha", "beta", "gamma"]
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert _annotations(tmp_path / "prof" / "trace.json") == ["tool"]
    assert os.path.exists(os.path.join(wd, "SUCCESS"))


def test_profile_trace_holds_the_port_spans(inputs, tmp_path, monkeypatch):
    """--profile records the port's spans (trace.py) into trace.json: the
    `tool` root and each step's spans, the gene threads' too."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    prof = tmp_path / "prof"
    assert port_main(["-t", "environment-finder", "-k", "21",
                      "-i", inputs["reads"], "--seq", inputs["genes"],
                      "-o", str(tmp_path / "out"), "--coverage", "3",
                      "--maxradius", "100", "-p", "2",
                      "--work-dir", str(tmp_path / "wd"),
                      "--profile", str(prof)]) == 0
    names = _annotations(prof / "trace.json")
    assert names.count("tool") == 1
    for name in ("count", "count.parse", "count.launch", "count.finalize"):
        assert names.count(name) >= 1, name
    for name in ("env.gene", "env.seed", "picture", "write.gfa"):
        assert names.count(name) == 2, name
    assert names.count("bfs.direction") == 4


# ---------------------------------------------------------------------------
# every tool's workDir, port against JAX
# ---------------------------------------------------------------------------

STEMS = ("settle", "not_settle", "stay", "gone", "came_from_donor",
         "came_from_baseline", "came_from_both", "came_itself")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The verify recipe's reads (500 x 60 bp of a 3 kbp genome) and their
    first 100, two genes, a one-gene file, two graph.txt files, the FMT bins,
    a spades stub and 20 Hi-C pairs."""
    tmp = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(11)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    reads = tmp / "reads.fastq"
    reads.write_text("".join(
        f"@r{i}\n{g[s:s + 60]}\n+\n{'I' * 60}\n"
        for i, s in enumerate(rng.integers(0, 2940, size=500))))
    (tmp / "genes.fasta").write_text(
        f">geneA\n{g[1000:1120]}\n>geneB\n{g[2200:2300]}\n")
    (tmp / "gene.fasta").write_text(f">geneA\n{g[1000:1120]}\n")
    for i, (lo, hi) in enumerate(((900, 1200), (1050, 1400))):
        (tmp / f"env{i}.txt").write_text("".join(
            f"{g[j:j + 21]} {j % 7 + 1}\n" for j in range(lo, hi - 20)))
    # the FMT tools take the first 100 reads and bins of 10
    lines = reads.read_text().splitlines(keepends=True)
    (tmp / "few.fastq").write_text("".join(lines[:400]))
    bins = tmp / "bins"
    bins.mkdir()
    for stem in STEMS:
        for x in ("1", "2", "s"):
            (bins / f"{stem}_{x}.fastq").write_text("".join(lines[:40]))
    spades = tmp / "spades"
    spades.mkdir()
    (spades / "spades.py").write_text(SPADES_STUB)
    hic = []
    for mate in (1, 2):
        p = tmp / f"hic_{mate}.fastq"
        p.write_text("".join(
            f"@h{i}/{mate}\n{g[i * 37:i * 37 + 40]}\n+\n{'I' * 40}\n"
            for i in range(20)))
        hic.append(str(p))
    return {"reads": str(reads), "few": str(tmp / "few.fastq"),
            "genes": str(tmp / "genes.fasta"),
            "gene": str(tmp / "gene.fasta"), "bins": str(bins),
            "envs": [str(tmp / "env0.txt"), str(tmp / "env1.txt")],
            "spades": str(spades), "hic": hic}


def _tool_args(tool: str, d: dict, out: str) -> list[str]:
    r, f = d["reads"], d["few"]
    fmt = ["-k", "21", "-i", d["bins"], "--ext", "fastq", "-after", f]
    return {
        "environment-finder": ["-k", "21", "-i", r, "--seq", d["genes"],
                               "--coverage", "3", "--maxradius", "100"],
        "kmer-counter": ["-k", "21", "-i", r],
        "environment-finder-multi": ["-e", *d["envs"], "--seq", d["gene"]],
        "reads-classifier": ["-k", "21", "-i", r, "-r", r],
        "triple-reads-classifier": ["-k", "21", "-k2", "33", "-i", r,
                                    "-r", r],
        "seq-cov": ["-k", "21", "--from-donor", f, "--from-before", f,
                    "--from-both", f, "--itself", f, "-r", d["genes"]],
        "environment-assembler-finder": [
            "-k", "21", "-i", r, "--seq", d["gene"], "--maxradius", "100",
            "--coverage", "3", "--assembler", "spades",
            "--assemblerpath", d["spades"], "-pf", "50"],
        "fmt-visualiser": ["-donor", f, "-before", f, *fmt],
        "fmt-visualizer": ["-donor", f, "-before", f, *fmt],
        "recipient-visualiser": ["--seq", d["genes"], *fmt],
        "hic-pipeline": ["-k", "21", "-i", r, "--seq", d["gene"],
                         "--hi-c-r1", d["hic"][0], "--hi-c-r2", d["hic"][1],
                         "--coverage", "3", "--maxradius", "100",
                         "--first-pass-only", "true"],
    }[tool] + (["-o", out] if tool != "hic-pipeline" else [])


_STAMP = re.compile(r"log_\d{8}_\d{6}")


def _workdir(root: str) -> tuple[list[str], dict[str, bytes]]:
    """(every file name under root, stamps masked; the contents of the
    SUCCESS markers and the properties files, root masked)."""
    names, kept = [], {}
    for dirpath, _, files in os.walk(os.path.join(root, "wd")):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            names.append(_STAMP.sub("log_<stamp>", rel))
            if name.startswith("SUCCESS") or name.endswith(".properties"):
                with open(os.path.join(dirpath, name), "rb") as fh:
                    kept[rel] = fh.read().replace(root.encode(), b"<root>")
    # runs in one workDir within a second share their log file
    return sorted(set(names)), kept


@pytest.fixture
def cpu(monkeypatch):
    """Both packages on the CPU, MC_HOST_COUNT unset: jax_host_main sets it
    for the JAX package's runs alone, so that the port counts on its device
    path."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_HOST_COUNT", raising=False)


@pytest.mark.parametrize("tool", sorted(_TOOL_MODULES))
def test_workdir_matches_jax(tool, inputs, tmp_path, cpu):
    got = {}
    for name, main in (("jax", jax_host_main), ("port", port_main)):
        root = str(tmp_path / name)
        args = _tool_args(tool, inputs, os.path.join(root, "out"))
        assert main(["-t", tool, *args, "--work-dir",
                     os.path.join(root, "wd")]) == 0, name
        got[name] = _workdir(root)
    names, kept = got["port"]
    assert names == got["jax"][0]
    assert kept == got["jax"][1]
    assert kept[os.path.join("wd", "out.properties")] == \
        f"tool={tool}\n".encode()
    assert os.path.join("wd", "SUCCESS") in kept
    assert b"<root>" in kept[os.path.join("wd", "in.properties")]


def test_workdir_matches_jax_under_continue(inputs, tmp_path, cpu):
    """A second run with --continue skips and leaves the same workDir in
    both packages."""
    got = {}
    for name, main in (("jax", jax_host_main), ("port", port_main)):
        root = str(tmp_path / name)
        args = ["-t", "kmer-counter",
                *_tool_args("kmer-counter", inputs,
                            os.path.join(root, "out")),
                "--work-dir", os.path.join(root, "wd")]
        assert main(args) == 0
        os.remove(os.path.join(root, "wd", "out.properties"))
        assert main(args + ["--continue"]) == 0
        got[name] = _workdir(root)
    assert got["port"] == got["jax"]
    assert os.path.join("wd", "out.properties") not in got["port"][1]


#: the JAX tools that read MC_HOST_COUNT (metacherchant_tpu/tools/)
HOST_COUNT_TOOLS = ("environment-finder", "kmer-counter", "reads-classifier",
                    "fmt-visualiser", "fmt-visualizer", "recipient-visualiser",
                    "environment-assembler-finder", "seq-cov")


def _out_tree(root: str) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(os.path.join(root, "out")):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = \
                    fh.read().replace(root.encode(), b"<root>")
    return files


@pytest.mark.parametrize("tool", HOST_COUNT_TOOLS)
def test_host_count_matches_jax(tool, inputs, tmp_path, monkeypatch):
    """MC_HOST_COUNT=1 in both packages: the port counts with
    count_kmers_host, never count_kmers_device, and writes JAX's files."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_HOST_COUNT", "1")

    def refuse(*args, **kwargs):
        raise AssertionError("count_kmers_device called under MC_HOST_COUNT")

    got = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        root = str(tmp_path / name)
        with monkeypatch.context() as m:
            if name == "port":
                m.setattr(counting, "count_kmers_device", refuse)
            assert main(["-t", tool, *_tool_args(tool, inputs,
                                                 os.path.join(root, "out")),
                         "--work-dir", os.path.join(root, "wd")]) == 0, name
        got[name] = _out_tree(root)
    assert got["port"] and got["port"] == got["jax"]
