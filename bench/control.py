"""Run one cell with its control in the program's place in the check.

    python3 bench/control.py --workload <cell> --seed <n> --seconds <s>

The same run as ``bench/run.py`` (set-up, window, the program's answers
kept), but the answers held to the reference are the control's, worked
out from the same inputs: the join keeping one build match per probe
tuple (``phj_paper_16m``), the SSB sums in int32 (``ssb_sf2``).  Its line
has to read ``"correct": false``; the compared numbers it prints are the
upper readings the limits are set below.  The benchmark's own runs never
run it.
"""
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import run  # noqa: E402

if __name__ == "__main__":
    run.T_START = T_START
    sys.exit(run.main(control=True))
