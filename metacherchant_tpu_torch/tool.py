"""Tool framework: declarative typed parameters, workDir, logging, checkpoint.

Carried over from metacherchant_tpu/tool.py, after the reference CLI
framework (itmo:utils/tool/Tool.java, Parameter.java):
- declarative Parameter fields with names/short opts/defaults, POSIX-style
  parsing: --name value / -s value, booleans with optional true/false argument
  (Tool.parseArgs:626-659)
- global launch options: --work-dir (default 'workDir'), -p/--available-processors,
  --continue, --force, -v/--verbose (Tool.java:58-141)
- per-stage checkpoint: workDir/SUCCESS + in.properties; with --continue a
  stage whose SUCCESS exists and whose input parameters match is skipped
  (runAsStep, Tool.java:318-390). Without --force/--continue the reference
  prompts before overwriting a finished workDir (:407-430); this
  implementation logs a warning and proceeds (non-interactive divergence).
- out.properties: outputs recorded via add_output() are dumped after a
  successful run and reloaded when a run is skipped under --continue
  (Tool.java:356-390)
- multi-step tools via add_step(name, fn); --start/--finish bound which
  steps execute (Tool.java:94-101,475-530). Single-step tools treat their
  own NAME as the only valid stage. Each step checkpoints separately
  (SUCCESS.<step>) so --continue resumes mid-pipeline.
- logging to console + workDir/log + workDir/logs/log_<timestamp>
  (Tool.updateFileLoggers:666-687)
- --profile DIR writes a torch.profiler chrome trace of the run to
  DIR/trace.json, with the port's spans (trace.py) beside the kernels
"""
from __future__ import annotations

import contextlib
import datetime
import logging
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable

from . import trace


class ExecutionFailedException(Exception):
    pass


def tool_device():
    """The torch device of device.py (MC_PLATFORM); a device that cannot be
    had fails the tool."""
    from .device import device
    try:
        return device()
    except (RuntimeError, ValueError) as e:
        raise ExecutionFailedException(str(e)) from None


@dataclass
class Parameter:
    name: str
    type: type = str
    short: str | None = None
    mandatory: bool = False
    default: Any = None
    description: str = ""
    multi: bool = False
    lazy_default: Callable[["Tool"], Any] | None = None
    _value: Any = field(default=None, repr=False)
    _set: bool = field(default=False, repr=False)

    def get(self, tool: "Tool | None" = None):
        if self._set:
            return self._value
        if self.lazy_default is not None and tool is not None:
            return self.lazy_default(tool)
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
        # start/finish bound multi-stage runs
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
        self._steps: list[tuple[str, Callable[[], None]]] = []
        self._out_values: dict[str, str] = {}

    # -- parameter plumbing -------------------------------------------------
    def add_parameter(self, p: Parameter) -> Parameter:
        self._params.append(p)
        return p

    # -- steps / outputs ------------------------------------------------------
    def add_step(self, name: str, fn: Callable[[], None]) -> None:
        """Register a named pipeline step (itmo:utils/tool/Tool.java addStep
        :475-530). Steps run in registration order under per-step checkpoints
        and are addressable by --start/--finish."""
        self._steps.append((name, fn))

    def add_output(self, key: str, value) -> None:
        """Record an output value, dumped to out.properties after the run and
        reloaded when the run is skipped under --continue
        (Tool.java:356-390)."""
        self._out_values[key] = str(value)

    def get_output(self, key: str) -> str | None:
        return self._out_values.get(key)

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

    def _success_path(self) -> str:
        return os.path.join(self.work_dir.get(self), "SUCCESS")

    def _in_props_path(self) -> str:
        return os.path.join(self.work_dir.get(self), "in.properties")

    def _out_props_path(self) -> str:
        return os.path.join(self.work_dir.get(self), "out.properties")

    def _write_out_properties(self) -> None:
        with open(self._out_props_path(), "w") as f:
            f.write(f"tool={self.NAME}\n")
            for k in sorted(self._out_values):
                f.write(f"{k}={self._out_values[k]}\n")

    def _load_out_properties(self) -> None:
        try:
            with open(self._out_props_path()) as f:
                for line in f:
                    if "=" in line:
                        k, v = line.rstrip("\n").split("=", 1)
                        if k != "tool":
                            self._out_values.setdefault(k, v)
        except OSError:
            pass

    def _step_marker(self, name: str, multi: bool) -> str:
        if not multi:
            return self._success_path()
        return os.path.join(self.work_dir.get(self), f"SUCCESS.{name}")

    # -- lifecycle ----------------------------------------------------------
    def main(self, argv: list[str]) -> int:
        try:
            self.parse_args(argv)
            self._setup_logging()
            wd = self.work_dir.get(self)
            success = self._success_path()
            props = self._in_properties()
            steps = self._steps or [(self.NAME, self.run_impl)]
            multi = len(steps) > 1
            names = [n for n, _ in steps]
            i0, i1 = self._stage_bounds(names)
            try:
                with open(self._in_props_path()) as f:
                    old_props = f.read()
            except OSError:
                old_props = None
            resumable = self.continue_run.get(self) and old_props == props
            if os.path.exists(success):
                if resumable:
                    self.logger.info(
                        "Stage %s already done, skipping (--continue)", self.NAME)
                    self._load_out_properties()
                    return 0
                if not self.continue_run.get(self) and not self.force_run.get(self):
                    self.logger.warning(
                        "workDir %s contains results of a finished run; "
                        "overwriting (pass --continue to resume)", wd)
                os.remove(success)
            os.makedirs(wd, exist_ok=True)
            with open(self._in_props_path(), "w") as f:
                f.write(props)

            def run_steps() -> None:
                for idx, (name, fn) in enumerate(steps):
                    marker = self._step_marker(name, multi)
                    if idx < i0 or idx > i1:
                        self.logger.info(
                            "Stage %s outside --start/--finish bounds, not running",
                            name)
                        continue
                    if resumable and os.path.exists(marker):
                        self.logger.info(
                            "Stage %s already done, skipping (--continue)", name)
                        continue
                    if os.path.exists(marker):
                        os.remove(marker)
                    if multi:
                        self.logger.info("Running stage %s", name)
                    fn()
                    if multi:
                        with open(marker, "w"):
                            pass

            # a profiled run records the port's spans into its trace
            prof = self.profile_dir.get(self)
            with (self._profiled(prof) if prof
                  else contextlib.nullcontext()), \
                    trace.span("tool", tool=self.NAME):
                run_steps()
                self.clean_impl()
            self._write_out_properties()
            all_done = all(
                os.path.exists(self._step_marker(n, multi)) for n in names
            ) if multi else i1 == len(steps) - 1
            if all_done:
                with open(success, "w"):
                    pass
            return 0
        except (ExecutionFailedException, NotImplementedError) as e:
            self.logger.error("%s", e)
            return 1

    def _stage_bounds(self, names: list[str]) -> tuple[int, int]:
        """Resolve --start/--finish into step-index bounds, validating names
        (itmo:utils/tool/Tool.java:94-101: firstStep/lastStep options)."""
        start = self.start_stage.get(self)
        finish = self.finish_stage.get(self)
        for bound, flag in ((start, "--start"), (finish, "--finish")):
            if bound is not None and bound not in names:
                raise ExecutionFailedException(
                    f"Unknown stage for {flag}: {bound!r} "
                    f"(stages: {', '.join(names)})")
        i0 = names.index(start) if start is not None else 0
        i1 = names.index(finish) if finish is not None else len(names) - 1
        if i1 < i0:
            raise ExecutionFailedException(
                f"--finish stage {finish!r} precedes --start stage {start!r}")
        return i0, i1

    @contextlib.contextmanager
    def _profiled(self, prof: str):
        """torch.profiler and the port's span recording over the block; the
        chrome trace goes to prof/trace.json when the block succeeds."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.logger.info("Profiling run to %s", prof)
        with profile(activities=activities,
                     experimental_config=trace.all_threads()) as p, \
                trace.recording():
            yield
        os.makedirs(prof, exist_ok=True)
        p.export_chrome_trace(os.path.join(prof, "trace.json"))

    def run_impl(self) -> None:
        raise NotImplementedError

    def clean_impl(self) -> None:
        pass

    # logging helpers mirroring Tool.info/warn/debug/error (Tool.java:1075-1126)
    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warn(self, msg, *args):
        self.logger.warning(msg, *args)

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)
