"""device_idle: the share of the traced window in which no kernel, copy
or memset ran on the device."""

import devtrace


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["dev"]:
        return None
    return 1.0 - devtrace.busy(t["dev"], t["lo"], t["hi"]) / (t["hi"] - t["lo"])
