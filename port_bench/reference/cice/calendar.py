"""Model calendar.

A copy of ``cice5_tpu/calendar.py``; functional equivalent of
ice_calendar.F90:123-420:
given (step index, dt, config) compute date fields, rather than mutating
module globals each step. Host-side (plain Python ints/floats) — the calendar
feeds forcing interpolation weights and output triggers, all of which are
resolved on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

daycal365 = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334, 365)
daycal366 = (0, 31, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335, 366)
daycal360 = tuple(30 * i for i in range(13))


def is_leap(year: int) -> bool:
    return (year % 4 == 0 and year % 100 != 0) or year % 400 == 0


@dataclass(frozen=True)
class DateTimeInfo:
    istep: int
    time: float          # seconds since year_init-01-01 00:00:00
    year: int
    month: int           # 1..12
    mday: int            # day of month, 1..31
    yday: float          # fractional day of year (1.0 at Jan 1 00:00)
    sec: int             # seconds into the day
    elapsed_days: int


class Calendar:
    """Calendar with 365-day (no-leap), 360-day, or proleptic-Gregorian leap
    years (ice_calendar.F90:185-310 'calendar' + time2sec/sec2time)."""

    def __init__(self, year_init: int, days_per_year: int = 365,
                 use_leap_years: bool = False):
        if days_per_year not in (360, 365):
            raise ValueError("days_per_year must be 360 or 365")
        self.year_init = year_init
        self.days_per_year = days_per_year
        self.use_leap_years = use_leap_years and days_per_year == 365

    def _year_len(self, year: int) -> int:
        if self.days_per_year == 360:
            return 360
        return 366 if (self.use_leap_years and is_leap(year)) else 365

    def _daycal(self, year: int):
        if self.days_per_year == 360:
            return daycal360
        return daycal366 if (self.use_leap_years and is_leap(year)) else daycal365

    def info(self, istep: int, dt: float, sec_init: int = 0) -> DateTimeInfo:
        time = istep * dt + sec_init
        tsec = int(time)
        days, sec = divmod(tsec, 86400)
        year = self.year_init
        while days >= self._year_len(year):
            days -= self._year_len(year)
            year += 1
        cal = self._daycal(year)
        month = 1
        while month < 12 and days >= cal[month]:
            month += 1
        mday = days - cal[month - 1] + 1
        yday = days + 1 + sec / 86400.0
        return DateTimeInfo(istep=istep, time=time, year=year, month=month,
                            mday=mday, yday=yday, sec=sec,
                            elapsed_days=int(tsec // 86400))
