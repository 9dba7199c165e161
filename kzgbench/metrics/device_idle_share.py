"""device_idle_share: the traced window less the union of its device
events (kernels, copies, sets), over the traced window, in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
