"""The process's clock: seconds since the process started. Imports
nothing heavy, so that ``run.py`` can read it before torch loads."""

from __future__ import annotations

import os
import time


class Clock:
    """Seconds since the process started (its start time from
    /proc/self/stat where there is one, else this object's creation)."""

    def __init__(self):
        self.t0 = time.time()
        try:
            with open("/proc/self/stat") as f:
                ticks = int(f.read().rsplit(")", 1)[1].split()[19])
            with open("/proc/uptime") as f:
                up = float(f.read().split()[0])
            self.t0 = time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
        except (OSError, ValueError, IndexError):
            pass

    def since_start(self) -> float:
        return time.time() - self.t0
