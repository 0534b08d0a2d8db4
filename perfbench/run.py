"""Run one cell of the benchmark once (see perfbench/README.md):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
