"""Run one benchmark cell on the card (see ``nkbench/harness.py``).

    python3 nkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  Caches of the libraries the program builds
on go to fixed directories inside the checkout, so that only the first run
of a cell in a checkout builds or compiles anything.
"""

import os
import sys
import time

T_START = time.perf_counter()
CACHES = (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "cuda"))

if __name__ == "__main__":
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = repo  # the checkout's root, not nkbench/
    for var, sub in CACHES:
        os.environ[var] = os.path.join(repo, ".nkbench_cache", sub)
    # one process with few threads: the program's host work is one Python
    # thread, and idle OpenMP workers only contend with it for the cores
    os.environ["OMP_NUM_THREADS"] = "1"
    # a traced run profiles the window, then a solve: the profiler keeps
    # CUPTI between the two sessions, as torn down and set up again it
    # loses the records of the second session's first kernels
    os.environ["TEARDOWN_CUPTI"] = "0"
    from nkbench.harness import main

    sys.exit(main(t_start=T_START))
