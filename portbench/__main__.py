"""`python3 -m portbench`: one run of one cell (harness.main)."""

import time

# set-up is timed from here: the torch import and everything after it
T0 = time.time()

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
