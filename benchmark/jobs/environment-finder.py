"""Job launcher of environment-finder: one job is one CLI run of the tool
over the community's reads for the genes of its job slot, with the
configuration's k, coverage and radius, one output directory per gene."""


def argv(cfg: dict, job) -> list[str]:
    return ["-t", "environment-finder", "-k", str(cfg["k"]),
            "-i", job.reads, "--seq", job.genes, "-o", job.out_dir,
            "--coverage", str(cfg["coverage"]),
            "--maxradius", str(cfg["maxradius"]),
            "--work-dir", job.work_dir]
