"""Date-partitioned input directory resolution (a copy of
``photon_tpu/io/paths.py``).

Counterpart of photon-client util/DateRange.scala:107,
DaysRange.scala and IOUtils.getInputPathsWithinDateRange
(util/IOUtils.scala:115-150): input data laid out daily as
``baseDir/yyyy/MM/dd/<files>`` is selected by an inclusive ``yyyymmdd-
yyyymmdd`` date range, or a ``N-M`` days-ago range resolved against today.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

DATE_PATTERN = "%Y%m%d"  # DateRange.DEFAULT_PATTERN "yyyyMMdd"
RANGE_DELIMITER = "-"


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] calendar range (util/DateRange.scala:107)."""

    start: datetime.date
    end: datetime.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"invalid range: start {self.start} comes after end "
                f"{self.end}")

    @staticmethod
    def from_string(range_str: str) -> "DateRange":
        """Parse "yyyymmdd-yyyymmdd" (DateRange.fromDateString :70)."""
        parts = range_str.split(RANGE_DELIMITER)
        if len(parts) != 2:
            raise ValueError(
                f"invalid date range {range_str!r}; expected "
                "yyyymmdd-yyyymmdd")
        start = datetime.datetime.strptime(parts[0], DATE_PATTERN).date()
        end = datetime.datetime.strptime(parts[1], DATE_PATTERN).date()
        return DateRange(start, end)

    def days(self):
        d = self.start
        while d <= self.end:
            yield d
            d += datetime.timedelta(days=1)


@dataclasses.dataclass(frozen=True)
class DaysRange:
    """Inclusive [start_days, end_days]-ago range (util/DaysRange.scala):
    "90-1" means from 90 days ago through yesterday."""

    start_days: int
    end_days: int

    def __post_init__(self):
        if self.start_days < self.end_days:
            raise ValueError(
                f"invalid days range: start {self.start_days} must be >= "
                f"end {self.end_days} (days ago)")
        if self.end_days < 0:
            raise ValueError("days ago must be non-negative")

    @staticmethod
    def from_string(range_str: str) -> "DaysRange":
        parts = range_str.split(RANGE_DELIMITER)
        if len(parts) != 2:
            raise ValueError(
                f"invalid days range {range_str!r}; expected N-M")
        return DaysRange(int(parts[0]), int(parts[1]))

    def to_date_range(
        self, today: datetime.date | None = None
    ) -> DateRange:
        today = today or datetime.date.today()
        return DateRange(
            today - datetime.timedelta(days=self.start_days),
            today - datetime.timedelta(days=self.end_days),
        )


def paths_for_date_range(
    base_dirs: list[str] | str,
    date_range: DateRange,
    *,
    error_on_missing: bool = False,
) -> list[str]:
    """Existing ``base/yyyy/MM/dd`` paths inside the range
    (IOUtils.getInputPathsWithinDateRange :115-150)."""
    if isinstance(base_dirs, str):
        base_dirs = [base_dirs]
    out: list[str] = []
    for base in base_dirs:
        found = []
        for day in date_range.days():
            p = os.path.join(
                base, f"{day.year:04d}", f"{day.month:02d}",
                f"{day.day:02d}")
            if os.path.isdir(p):
                found.append(p)
            elif error_on_missing:
                raise FileNotFoundError(
                    f"missing daily input dir {p} for {day}")
        if not found:
            raise FileNotFoundError(
                f"no daily input dirs under {base} within "
                f"{date_range.start}..{date_range.end}")
        out.extend(found)
    return out
