"""Share of the profiled steps' wall time in which no kernel, copy or set
ran on the device."""


def read(ctx):
    prof = ctx["profile"]
    if not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
