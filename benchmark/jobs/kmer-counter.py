"""Job launcher of kmer-counter: one job is one CLI run of the tool over the
community's reads with the configuration's k and threshold (-b)."""


def argv(cfg: dict, job) -> list[str]:
    return ["-t", "kmer-counter", "-k", str(cfg["k"]), "-i", job.reads,
            "-b", str(cfg["threshold"]), "-o", job.out_dir,
            "--work-dir", job.work_dir]
