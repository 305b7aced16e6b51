"""Model clock, calendar and event triggers.

Reference: ``src/gen_modules_clock.F90`` (module g_clock :23-199, clock file
:68-146) and ``src/gen_events.F90:4-91`` (annual/monthly/daily/hourly/step
event checks).

The port's own copy of ``fesom2_tpu/utils/clock.py``, kept
line for line (the port imports nothing of the JAX package;
``tests/test_torch_forcing_files.py`` holds the two equal).
"""
from __future__ import annotations

from dataclasses import dataclass, field

_MONTH_DAYS = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def is_leap(year: int, include_leap: bool) -> bool:
    if not include_leap:
        return False
    return (year % 4 == 0 and year % 100 != 0) or year % 400 == 0


def days_in_year(year: int, include_leap: bool) -> int:
    return 366 if is_leap(year, include_leap) else 365


def month_day(yearday: int, year: int, include_leap: bool):
    """1-based (month, day_in_month) for 1-based day-of-year."""
    md = list(_MONTH_DAYS)
    if is_leap(year, include_leap):
        md[1] = 29
    m = 0
    d = yearday
    while d > md[m]:
        d -= md[m]
        m += 1
    return m + 1, d


@dataclass
class Clock:
    """Seconds-within-day + day-of-year + year, advanced per step."""
    timenew: float = 0.0      # seconds in day
    daynew: int = 1           # day of year (1-based)
    yearnew: int = 1948
    include_leap: bool = False

    def advance(self, dt: float):
        self.timenew += dt
        if self.timenew >= 86400.0 - 1e-6:
            self.timenew -= 86400.0
            self.daynew += 1
            if self.daynew > days_in_year(self.yearnew, self.include_leap):
                self.daynew = 1
                self.yearnew += 1

    @property
    def seconds_in_year(self) -> float:
        return (self.daynew - 1) * 86400.0 + self.timenew

    @property
    def month(self) -> int:
        return month_day(self.daynew, self.yearnew, self.include_leap)[0]

    def copy(self) -> "Clock":
        return Clock(self.timenew, self.daynew, self.yearnew, self.include_leap)


def event_triggered(unit: str, freq: int, clock_before: Clock,
                    clock_after: Clock, step: int) -> bool:
    """True when an output event fires between two clock states.

    unit: 'y' annual, 'm' monthly, 'd' daily, 'h' hourly, 's' per-steps
    (reference gen_events.F90 semantics: trigger on boundary crossing).
    """
    if unit == "s":
        return (step + 1) % max(freq, 1) == 0
    if unit == "h":
        h0 = int(clock_before.timenew // 3600) + clock_before.daynew * 24 \
            + clock_before.yearnew * 9000
        h1 = int(clock_after.timenew // 3600) + clock_after.daynew * 24 \
            + clock_after.yearnew * 9000
        return (h1 - h0) >= 1 and h1 % max(freq, 1) == 0
    if unit == "d":
        changed = (clock_after.daynew != clock_before.daynew
                   or clock_after.yearnew != clock_before.yearnew)
        return changed and clock_after.daynew % max(freq, 1) == 1 \
            if freq > 1 else changed
    if unit == "m":
        return clock_after.month != clock_before.month \
            or clock_after.yearnew != clock_before.yearnew
    if unit == "y":
        return clock_after.yearnew != clock_before.yearnew
    raise ValueError(f"unknown event unit {unit!r}")


def write_clock_file(path: str, clock: Clock):
    """runid.clock companion file (ref gen_modules_clock.F90:146-160)."""
    with open(path, "w") as fh:
        fh.write(f"{clock.timenew} {clock.daynew} {clock.yearnew}\n")
        fh.write(f"{clock.timenew} {clock.daynew} {clock.yearnew}\n")


def read_clock_file(path: str) -> Clock:
    with open(path) as fh:
        fh.readline()
        t, d, y = fh.readline().split()
    return Clock(float(t), int(float(d)), int(float(y)))
