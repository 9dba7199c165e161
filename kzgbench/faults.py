"""Faults planted under the timed path, and the control.

Each is a function (program, pool) -> the object the window calls in the
program's place; it breaks the cell's entry and leaves the program's other
calls as they are. The benchmark's own runs use none of them: the card
test (tests/test_kzgbench_card.py) reads the control at the cells' own
sizes, and the CPU tests run every one at a small size, to see `correct`
come out false.
"""

from __future__ import annotations

from kzgbench.reference import kzg as REF


class _Broken:
    def __init__(self, program, entry: str, fn):
        self._program = program
        setattr(self, entry, fn)

    def __getattr__(self, name):
        return getattr(self._program, name)


def stale(program, pool):
    """A step that returns its state unchanged: every call answers with the
    first call's output."""
    entry = getattr(program, pool.entry)
    first = []

    def fn(*args):
        if not first:
            first.append(entry(*args))
        return first[0]

    return _Broken(program, pool.entry, fn)


def half_batch(program, pool):
    """Half of the batch left out: a prove or a recovery computes the first
    half of its blobs and answers for the rest with copies of them; a verify
    checks every other cell."""
    entry = getattr(program, pool.entry)

    def fn(*args):
        if pool.kind == "verify":
            return entry(*(a[::2] for a in args))
        items = args[0]
        half = entry(items[: -(-len(items) // 2)])
        return [half[i % len(half)] for i in range(len(items))]

    return _Broken(program, pool.entry, fn)


class InvalidProofError(Exception):
    """A turned-over verdict: the window reads a verify's verdict by its class name."""


def altered(program, pool):
    """An answer altered where it is produced: one bit of the first cell of
    the first blob, or the verdict turned over."""
    entry = getattr(program, pool.entry)

    def fn(*args):
        if pool.kind == "verify":
            try:
                entry(*args)
            except Exception as exc:
                if type(exc).__name__ == "InvalidProofError":
                    return None
                raise
            raise InvalidProofError("verdict turned over")
        out = [list(x) for x in entry(*args)]
        cells = list(out[0][0])
        cells[0] = cells[0][:-1] + bytes([cells[0][-1] ^ 1])
        out[0][0] = tuple(cells)
        return [tuple(x) for x in out]

    return _Broken(program, pool.entry, fn)


def control(program, pool):
    """The control: the program with one of the configuration's guarantees
    broken, in the step a later change would be tempted to save. A prove or
    a recovery emits its cells' scalars unreduced by one modulus (v + r,
    which 32 bytes still hold: the last conditional subtraction skipped); a
    verify runs its host checks and skips the pairing check, accepting every
    well-formed batch."""
    entry = getattr(program, pool.entry)

    def fn(*args):
        if pool.kind == "verify":
            checks = getattr(program, "verify_inputs", None)
            if checks is not None:
                checks(*args)
            return None
        out = entry(*args)
        lazy = []
        for cells, proofs in out:
            lazy.append((tuple(REF.scalars_to_bytes(v + REF.R for v in REF.scalars_from_bytes(c)) for c in cells),
                         proofs))
        return lazy

    return _Broken(program, pool.entry, fn)


FAULTS = {"stale": stale, "half_batch": half_batch, "altered": altered}
