"""polish_windows_s: stage 4's consensus windows on their worker threads,
in seconds a window assembly: the program's consensus.windows span (the
pool from its first window's start to its last one's end)."""

import progspans


def read(ctx):
    return progspans.mean(ctx, progspans.seconds("consensus.windows",
                                                  "polish"))
