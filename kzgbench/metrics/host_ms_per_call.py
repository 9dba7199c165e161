"""host_ms_per_call: a traced call's host-clock wall less the device time
inside it (the union of device events within its span), averaged over the
traced calls: the API's byte codecs and host checks, launches and waits."""


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    return sum((e - s) - tr.busy_s(s, e) for s, e in tr.calls) / len(tr.calls) * 1e3
