"""The control of `correct`: the reference put in the program's place, with
every k-mer's count merged under a narrower key, must come out as not
correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--jobs 3]

For each seed it makes the cell's inputs on the card as a run does, works
out the outputs of the first --jobs window jobs with the exact reference and
with counts merged under 32 bits of each key (the narrower table a later PR
might try), and prints the numbers the run compares, beside their limits,
as one JSON line per seed. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(root: Path, cell: str, seed: int, jobs: int,
                    key_bits: int = 32, device: str = "cuda",
                    where: str | None = None) -> dict:
    """The control's numbers for one seed, summed over `jobs` jobs, with
    counts merged under `key_bits` bits of each key."""
    from benchmark import core, datagen
    c = core.load_cell(root, cell)
    tmp = tempfile.mkdtemp(prefix="mc-control-", dir=where)
    try:
        inputs = datagen.make_inputs(c.cfg, c.mix, seed, tmp, device,
                                     c.inputs)
        genes = [inputs.genes_of(i + 1) for i in range(jobs)]
        ref = c.reference
        dev = torch.device(device)
        files = core.hook_files(inputs)
        want = ref.solve(c.cfg, inputs.reads, genes, dev, **files)
        got = ref.solve(c.cfg, inputs.reads, genes, dev, key_bits=key_bits,
                        **files)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return core.compare_all(ref, zip(want, got))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args()
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(ROOT, args.workload, seed, args.jobs)
        failed = [k for k, v in nums.items() if v["value"] > v["limit"]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "jobs": args.jobs,
                          "control_fails": bool(failed), "compared": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
