"""Run one cell of the benchmark of ipddp2tpu_torch on the H100:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the lines before it name the card and give each batch's
seconds and lockstep iterations; the last lines of standard error give each
number compared against its limit. Without a CUDA device it prints no
result and exits with 2. See `harness.py`.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the program's caches live at fixed places inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(HERE / ".cache" / sub)
# one host thread for the host's own tensor work: the solve is paced by the
# host, which it shares with other machines' work
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
