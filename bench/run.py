"""The benchmark's command: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It drives the port (``src/repro_torch``) and nothing else of the
repository, keeps every build and kernel cache inside the checkout
(``build/``), runs with one CPU thread for each library's thread pool
(the server is paced by its host thread, which spinning pool threads
would slow), and prints its result as the last line of its standard
output; see ``bench/README.md``.
"""
import time

_PERF0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (the interpreter's
    own start-up included), or this module's start where /proc says
    nothing."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _PERF0


if __name__ == "__main__":
    t_start = min(_PERF0, _process_start())
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.harness.main import main

    sys.exit(main(t_start=t_start))
