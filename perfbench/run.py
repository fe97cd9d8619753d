"""Entry point of the benchmark: ``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout (or ``python -m perfbench.run ...``).  See ``harness.py``."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
