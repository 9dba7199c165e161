"""blobs_per_s: blobs proved, recovered, or whose cells were verified, over
the whole window: every call that started in the window and returned, over
the time from the first call's start to the last one's return."""


def read(run):
    return run.blobs / run.window_s if run.window_s > 0 else None
