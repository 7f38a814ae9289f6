"""Column filters for series selection (reference core/.../query/Filter —
Equals / NotEquals / EqualsRegex / NotEqualsRegex / In / NotIn over tag values).

PromQL matcher semantics: regex matchers are fully anchored (^...$).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class ColumnFilter:
    column: str
    op: str  # "=", "!=", "=~", "!~", "in", "not in"
    value: str | tuple[str, ...]

    def matches(self, v: str | None) -> bool:
        val = v if v is not None else ""
        if self.op == "=":
            return val == self.value
        if self.op == "!=":
            return val != self.value
        if self.op == "=~":
            return re.fullmatch(self.value, val) is not None
        if self.op == "!~":
            return re.fullmatch(self.value, val) is None
        if self.op == "in":
            return val in self.value
        if self.op == "not in":
            return val not in self.value
        raise ValueError(f"unknown filter op {self.op}")


def equals(column: str, value: str) -> ColumnFilter:
    return ColumnFilter(column, "=", value)


def regex(column: str, pattern: str) -> ColumnFilter:
    return ColumnFilter(column, "=~", pattern)
