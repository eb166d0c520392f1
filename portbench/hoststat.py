"""What the host did while the window ran, read from ``/proc``: the user
and the system CPU seconds of one process (the daemon's, which does each
sample's work) and the seconds that the machine's CPUs lost to other
guests of its host (``steal``). Set beside each sample's wall, they tell
a CPU that runs slower from a kernel that works more for the program
(page faults, copies) and from a machine that waits: the harness prints
them and compares nothing with them. Each reading is None where
``/proc`` does not give it."""

from __future__ import annotations

import os
from typing import Optional, Tuple

_TICK = os.sysconf("SC_CLK_TCK")


def process_cpu_s(pid) -> Tuple[Optional[float], Optional[float]]:
    """(user, system) CPU seconds of ``pid`` so far."""
    try:
        with open(f"/proc/{int(pid)}/stat") as fh:
            f = fh.read().rsplit(")", 1)[1].split()
        return int(f[11]) / _TICK, int(f[12]) / _TICK
    except (OSError, ValueError, IndexError, TypeError):
        return None, None


def steal_s() -> Optional[float]:
    """Seconds stolen from this machine's CPUs so far, summed over them."""
    try:
        with open("/proc/stat") as fh:
            f = fh.readline().split()
        return int(f[8]) / _TICK
    except (OSError, ValueError, IndexError):
        return None


#: what each of :func:`reading`'s values is
NAMES = ("the daemon's user CPU", "the daemon's system CPU", "stolen CPU")


def reading(pid) -> tuple:
    return (*process_cpu_s(pid), steal_s())
