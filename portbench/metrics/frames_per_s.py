"""Frames delivered to the host in the window over the window's seconds
(host clock).  The window runs from its start to the arrival of the first
chunk of frames that arrives after ``run_seconds``, so whole chunks count
over the time they took."""


def read(ctx):
    s = ctx["stats"]
    if "frames" not in s:
        return None
    return s["frames"] / s["window_s"]
