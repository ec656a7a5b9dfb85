"""One run of one benchmark cell of the PyTorch and CUDA port (repro_torch).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``fedbench/cli.py`` has the details.
"""
import os
import sys
import time


def _since_process_start() -> float:
    """Seconds since this process started (0.0 where the system does not say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _since_process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from fedbench import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(t_start=T_START))
