"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints progress lines, then as its last line
one JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device, with --trace 1
breakdown, and last `compared`, each number the reference compared beside
its limit (also the last lines of standard error). Exits non-zero with no
result where torch sees fewer CUDA devices than the cell asks for, or where
a module of JAX or of the JAX package is loaded once the window has closed.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, is where the port and the
# benchmark's package are found
sys.path[0] = ROOT

if __name__ == "__main__":
    from benchmark import core
    sys.exit(core.main())
