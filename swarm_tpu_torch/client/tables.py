"""Minimal ASCII table renderer, the port's copy of
``swarm_tpu/client/tables.py`` (no third-party table package needed)."""

from __future__ import annotations


class Table:
    def __init__(self, field_names: list[str]):
        self.field_names = [str(f) for f in field_names]
        self.rows: list[list[str]] = []

    def add_row(self, row) -> None:
        self.rows.append([("" if v is None else str(v)) for v in row])

    def __str__(self) -> str:
        widths = [len(f) for f in self.field_names]
        for row in self.rows:
            for i, cell in enumerate(row):
                widths[i] = max(widths[i], len(cell))
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = [sep]
        out.append(
            "|"
            + "|".join(f" {f:<{w}} " for f, w in zip(self.field_names, widths))
            + "|"
        )
        out.append(sep)
        for row in self.rows:
            out.append(
                "|" + "|".join(f" {c:<{w}} " for c, w in zip(row, widths)) + "|"
            )
        out.append(sep)
        return "\n".join(out)
