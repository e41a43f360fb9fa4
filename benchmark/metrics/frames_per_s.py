"""Frames of all requests completed in the window over the window's seconds
(from the first submit to the last request's end), host clock."""


def read(run):
    if not run.spans:
        return None
    return len(run.spans) * run.workload["frames"] / run.window_s
