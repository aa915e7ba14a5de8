"""The benchmark of redtime_tpu_torch, one cell, one run:

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with a CUDA card.  Prints the
compared numbers beside their limits as the last lines on standard
error, and the result as one JSON line, last on standard output.  Exits
non-zero, with no result, without a card or when JAX is loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
# the checkout's root in place of this script's directory, whose modules
# are imported as rtbench.<name>
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from rtbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
