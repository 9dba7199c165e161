"""Closed loop, one caller: each call starts when the last one has returned,
the pool taken in turn."""

import time


def drive(window, pacing: dict, seed: int, seconds: float | None, calls: int | None) -> None:
    """Calls start until `seconds` have passed, or `calls` have been made."""
    n = len(window.pool)
    deadline = None if seconds is None else time.perf_counter() + seconds
    i = 0
    while (calls is None or i < calls) and (deadline is None or time.perf_counter() < deadline):
        window.one(i % n)
        i += 1
