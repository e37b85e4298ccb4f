"""The 95th percentile of the window's per-request solve times
(statistics' exclusive method), where the window holds 20 solves or
more."""

import statistics


def read(run):
    if len(run.requests) < 20:
        return None
    return statistics.quantiles([r["seconds"] for r in run.requests],
                                n=20)[-1]
