"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits non-zero, printing no result, where
the card or the program is missing (see ``benchmark/harness.py``).
"""

import os
import sys

os.environ.setdefault("USE_FLAX", "0")   # libraries that would load JAX by themselves
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
