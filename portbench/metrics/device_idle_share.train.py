"""Share of the traced window in which no kernel, copy or memset ran on the
card (profiler trace)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
