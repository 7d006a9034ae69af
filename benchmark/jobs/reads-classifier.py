"""Job launcher of reads-classifier: one job is one CLI run of the tool
that classifies the recipient's pairs (the input hook's mate files) against
the donor's dump, with the configuration's k and the tool's defaults for
-found, --interval95 and --correction. The configuration's "env" entries
(MC_DEVICE_CLASSIFY) go into the process's environment first: a run is one
process for one cell."""
import os


def argv(cfg: dict, job) -> list[str]:
    os.environ.update(cfg.get("env", {}))
    return ["-t", "reads-classifier", "-k", str(cfg["k"]),
            "-i", job.files["dump"],
            "-r", job.files["mate1"], job.files["mate2"],
            "-o", job.out_dir, "--work-dir", job.work_dir]
