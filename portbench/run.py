#!/usr/bin/env python3
"""The port's benchmark: one cell, once, in this process.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and ``checks`` last: each number compared with its limit);
the last lines of standard error repeat the checks. See
``portbench/README.md``.
"""

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


_AGE0 = _process_age_s()
_T0 = time.perf_counter()


def setup_clock() -> float:
    """Seconds since the process started, on the monotonic clock."""
    return _AGE0 + time.perf_counter() - _T0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.harness import cli

    sys.exit(cli.main(sys.argv[1:], setup_clock))
