"""Job launcher of the stand-in kmer-counter-pairs: one CLI run of
kmer-counter over both mate files of the input hook (-i <mate 1> <mate 2>),
with the configuration's k and threshold (-b)."""


def argv(cfg: dict, job) -> list[str]:
    return ["-t", "kmer-counter", "-k", str(cfg["k"]),
            "-i", job.files["mate1"], job.files["mate2"],
            "-b", str(cfg["threshold"]), "-o", job.out_dir,
            "--work-dir", job.work_dir]
