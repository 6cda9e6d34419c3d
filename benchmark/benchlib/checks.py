"""The numbers that decide ``correct``, each beside its limit."""

from __future__ import annotations

import statistics


class Checks:
    """Named numbers compared with the cell's limits
    (``benchmark/limits/<workload>.json``): a number passes when it is at
    most its limit.  A number the file gives no limit is printed and not
    compared (``info``): the limits file says what decides ``correct``."""

    def __init__(self, limits: dict) -> None:
        self.limits = limits
        self.values: dict[str, float] = {}
        self.info: dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        if name in self.limits:
            self.values[name] = float(value)
        else:
            self.info[name] = float(value)

    def failed(self) -> list[str]:
        return [n for n, v in self.values.items()
                if not (n in self.limits and v <= self.limits[n])]

    @property
    def correct(self) -> bool:
        return bool(self.values) and not self.failed()

    def table(self) -> dict:
        """{name: {"value", "limit"}}, for the result line's last key."""
        return {n: {"value": v, "limit": self.limits.get(n)}
                for n, v in self.values.items()}

    def lines(self) -> list[str]:
        return [f"check {n}: {v!r} (limit {self.limits.get(n)!r})"
                f"{'' if n in self.limits and v <= self.limits[n] else ' FAILED'}"
                for n, v in self.values.items()]


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list[float]:
    """Each leaf's gap between the program's and the reference's norm,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger; over the leaves ``keep`` (all by default)."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
            for n in names]


def diff_gaps(diff: dict, ref: dict, keep=None) -> dict:
    """{leaf: the norm of the difference between the program's tensor and
    the reference's (``diff``), over the reference's norm of that leaf or
    of the median leaf, whichever is larger}, over the leaves ``keep``:
    a gap of direction as well as of size."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    return {n: diff[n] / max(ref[n], median, 1e-30) for n in names}
