"""Seconds from the process's start to the window's: imports, the kernel
library's load (its build on a checkout's first run), writing the inputs,
the scene's commit and host build, and the warm-up (host clock)."""


def read(ctx):
    return ctx["stats"]["setup_s"]
