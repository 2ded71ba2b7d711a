"""The comparison that decides ``correct``: exact, so every limit is 0."""

from __future__ import annotations

from collections import Counter

NUMBERS = ("rows_differing", "summary_differing", "order_differs")


def compare(got: bytes, want: bytes) -> dict:
    """Data rows in one and not the other (as multisets), the same of the
    ``#`` lines, and 1 where both hold the same lines in another order."""
    if got == want:
        return dict.fromkeys(NUMBERS, 0)
    a, b = got.split(b"\n"), want.split(b"\n")
    diff = (Counter(a) - Counter(b)) + (Counter(b) - Counter(a))
    summary = sum(n for line, n in diff.items() if line.startswith(b"#"))
    rows = sum(diff.values()) - summary
    return {"rows_differing": rows, "summary_differing": summary,
            "order_differs": int(rows == 0 and summary == 0)}


def total(results: list) -> dict:
    """Each number summed over every output compared."""
    return {n: sum(r[n] for r in results) for n in NUMBERS}
