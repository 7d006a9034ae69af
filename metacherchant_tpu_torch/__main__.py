"""`python -m metacherchant_tpu_torch` CLI entry."""
import sys

from .runner import main

if __name__ == "__main__":
    sys.exit(main())
