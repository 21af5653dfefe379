"""Run one cell of the benchmark of ``shadow1_tpu_torch`` once, on the
CUDA device(s) of this machine:

    python3 portbench/run.py --workload tor10k.seeds8 --seed 7 --seconds 20 --trace 0

The last line of standard output is the result (one JSON object); the
numbers compared against the reference are the last lines of standard
error. ``portbench/harness.py`` says what a run does.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
