"""Tool framework: declarative typed parameters, workDir, logging, checkpoint.

Carried over from metacherchant_tpu/tool.py for single-stage tools, after the
reference CLI framework (itmo:utils/tool/Tool.java, Parameter.java):
- declarative Parameter fields with names/short opts/defaults, POSIX-style
  parsing: --name value / -s value, booleans with optional true/false argument
  (Tool.parseArgs:626-659)
- global launch options: --work-dir (default 'workDir'), -p/--available-processors,
  --continue, --force, -v/--verbose (Tool.java:58-141)
- checkpoint: workDir/SUCCESS + in.properties; with --continue a run whose
  SUCCESS exists and whose input parameters match is skipped (runAsStep,
  Tool.java:318-390). Without --force/--continue the reference prompts before
  overwriting a finished workDir (:407-430); this implementation logs a
  warning and proceeds (non-interactive divergence).
- logging to console + workDir/log + workDir/logs/log_<timestamp>
  (Tool.updateFileLoggers:666-687)
- --profile DIR writes a torch.profiler chrome trace of the run to
  DIR/trace.json
"""
from __future__ import annotations

import datetime
import logging
import os
import sys
from dataclasses import dataclass, field
from typing import Any


class ExecutionFailedException(Exception):
    pass


@dataclass
class Parameter:
    name: str
    type: type = str
    short: str | None = None
    mandatory: bool = False
    default: Any = None
    description: str = ""
    multi: bool = False
    _value: Any = field(default=None, repr=False)
    _set: bool = field(default=False, repr=False)

    def get(self, tool: "Tool | None" = None):
        if self._set:
            return self._value
        return self.default

    def set(self, value) -> None:
        self._value = value
        self._set = True


def _parse_value(p: Parameter, raw: str):
    if p.type is bool:
        return raw.lower() in ("true", "1", "yes")
    if p.type is int:
        return int(raw)
    if p.type is float:
        return float(raw)
    return raw


class Tool:
    NAME = "tool"
    DESCRIPTION = ""

    def __init__(self):
        self._params: list[Parameter] = []
        self.work_dir = self.add_parameter(Parameter(
            "work-dir", str, short="w", default="workDir",
            description="working directory"))
        self.available_processors = self.add_parameter(Parameter(
            "available-processors", int, short="p",
            default=os.cpu_count() or 1,
            description="available processors"))
        self.continue_run = self.add_parameter(Parameter(
            "continue", bool, default=False,
            description="continue the previously terminated run"))
        self.force_run = self.add_parameter(Parameter(
            "force", bool, default=False,
            description="force run with rewriting old results"))
        self.verbose = self.add_parameter(Parameter(
            "verbose", bool, short="v", default=False,
            description="enable debug output"))
        # accepted-for-compatibility launch options (Tool.java:94-141): memory
        # sizing and assertions are JVM concepts with no effect here;
        # start/finish name the one stage of a single-stage tool
        self.memory = self.add_parameter(Parameter(
            "memory", str, short="m",
            description="memory to use (JVM-compat no-op)"))
        self.enable_assertions = self.add_parameter(Parameter(
            "ea", bool, default=False,
            description="enable assertions (JVM-compat no-op)"))
        self.start_stage = self.add_parameter(Parameter(
            "start", str, description="first stage to run"))
        self.finish_stage = self.add_parameter(Parameter(
            "finish", str, description="last stage to run"))
        self.profile_dir = self.add_parameter(Parameter(
            "profile", str,
            description="write a torch profiler trace of the run to this dir"))
        self.logger = logging.getLogger("metacherchant")

    # -- parameter plumbing -------------------------------------------------
    def add_parameter(self, p: Parameter) -> Parameter:
        self._params.append(p)
        return p

    def _find(self, opt: str) -> Parameter | None:
        for p in self._params:
            if opt == "--" + p.name or (p.short and opt == "-" + p.short):
                return p
        return None

    def parse_args(self, argv: list[str]) -> None:
        i = 0
        while i < len(argv):
            arg = argv[i]
            p = self._find(arg)
            if p is None:
                raise ExecutionFailedException(f"Unknown option {arg}")
            if p.type is bool:
                if i + 1 < len(argv) and argv[i + 1].lower() in (
                        "true", "false", "1", "0", "yes", "no"):
                    p.set(_parse_value(p, argv[i + 1]))
                    i += 2
                else:
                    p.set(True)
                    i += 1
            elif p.multi:
                vals = []
                i += 1
                while i < len(argv) and self._find(argv[i]) is None \
                        and not argv[i].startswith("--"):
                    vals.append(_parse_value(p, argv[i]))
                    i += 1
                p.set(vals)
            else:
                if i + 1 >= len(argv):
                    raise ExecutionFailedException(f"Option {arg} requires a value")
                p.set(_parse_value(p, argv[i + 1]))
                i += 2
        missing = [p.name for p in self._params if p.mandatory and not p._set]
        if missing:
            raise ExecutionFailedException(
                f"Mandatory parameter(s) not set: {', '.join('--' + m for m in missing)}")
        for bound, flag in ((self.start_stage.get(self), "--start"),
                            (self.finish_stage.get(self), "--finish")):
            if bound is not None and bound != self.NAME:
                raise ExecutionFailedException(
                    f"Unknown stage for {flag}: {bound!r} (stages: {self.NAME})")

    # -- logging / checkpoint ----------------------------------------------
    def _setup_logging(self) -> None:
        wd = self.work_dir.get(self)
        os.makedirs(os.path.join(wd, "logs"), exist_ok=True)
        root = logging.getLogger("metacherchant")
        root.setLevel(logging.DEBUG)
        for h in list(root.handlers):
            root.removeHandler(h)
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        console = logging.StreamHandler(sys.stderr)
        console.setLevel(logging.DEBUG if self.verbose.get(self) else logging.INFO)
        console.setFormatter(fmt)
        root.addHandler(console)
        latest = logging.FileHandler(os.path.join(wd, "log"), mode="w")
        latest.setFormatter(fmt)
        root.addHandler(latest)
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        ts = logging.FileHandler(os.path.join(wd, "logs", f"log_{stamp}"), mode="w")
        ts.setFormatter(fmt)
        root.addHandler(ts)

    # launch options (Tool.java:58-141) are not tool inputs: they must not
    # invalidate the in.properties checkpoint match on resume
    _LAUNCH_OPTIONS = ("continue", "force", "verbose", "start", "finish",
                       "memory", "ea", "profile")

    def _in_properties(self) -> str:
        lines = []
        for p in self._params:
            if p.name in self._LAUNCH_OPTIONS:
                continue
            lines.append(f"{p.name}={p.get(self)}")
        return "\n".join(lines) + "\n"

    # -- lifecycle ----------------------------------------------------------
    def main(self, argv: list[str]) -> int:
        try:
            self.parse_args(argv)
            self._setup_logging()
            wd = self.work_dir.get(self)
            success = os.path.join(wd, "SUCCESS")
            in_props = os.path.join(wd, "in.properties")
            props = self._in_properties()
            try:
                with open(in_props) as f:
                    old_props = f.read()
            except OSError:
                old_props = None
            if os.path.exists(success):
                if self.continue_run.get(self) and old_props == props:
                    self.logger.info(
                        "Stage %s already done, skipping (--continue)", self.NAME)
                    return 0
                if not self.continue_run.get(self) and not self.force_run.get(self):
                    self.logger.warning(
                        "workDir %s contains results of a finished run; "
                        "overwriting (pass --continue to resume)", wd)
                os.remove(success)
            with open(in_props, "w") as f:
                f.write(props)
            prof = self.profile_dir.get(self)
            if prof:
                self._run_profiled(prof)
            else:
                self.run_impl()
            with open(success, "w"):
                pass
            return 0
        except (ExecutionFailedException, NotImplementedError) as e:
            self.logger.error("%s", e)
            return 1

    def _run_profiled(self, prof: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.logger.info("Profiling run to %s", prof)
        with profile(activities=activities) as p:
            self.run_impl()
        os.makedirs(prof, exist_ok=True)
        p.export_chrome_trace(os.path.join(prof, "trace.json"))

    def run_impl(self) -> None:
        raise NotImplementedError

    # logging helper mirroring Tool.info (Tool.java:1075-1126)
    def info(self, msg, *args):
        self.logger.info(msg, *args)
