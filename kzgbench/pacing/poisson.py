"""Open loop, one caller: Poisson arrivals at `rate_per_s`, the pool taken in
turn. A call's latency runs from its arrival to its return, so a call that
arrives while another runs counts its wait. Every seed gets the same set of
gaps between arrivals, drawn from a fixed stream; the seed draws their order.
"""

import math
import random
import time


def gaps(rate_per_s: float, count: int, seed: int) -> list[float]:
    fixed = random.Random("kzgbench-poisson")
    out = [fixed.expovariate(rate_per_s) for _ in range(count)]
    random.Random(f"kzgbench-poisson-{seed}").shuffle(out)
    return out


def drive(window, pacing: dict, seed: int, seconds: float | None, calls: int | None) -> None:
    """Calls arrive until `seconds` have passed, or `calls` have arrived."""
    rate = pacing["rate_per_s"]
    count = calls if calls is not None else math.ceil(2 * rate * seconds) + 16
    n = len(window.pool)
    start = time.perf_counter()
    deadline = math.inf if seconds is None else start + seconds
    arrival = start
    for i, gap in enumerate(gaps(rate, count, seed)):
        arrival += gap
        if arrival >= deadline:
            break
        wait = arrival - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        window.one(i % n, arrival=arrival)
