"""Share of the profiled part of the window, in %, in which no kernel,
copy or set ran on the card (device trace)."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
