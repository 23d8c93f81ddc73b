"""``solve_p90_ms``: the 90th percentile of the window's solves, each timed
from its start to its synchronised end (host clock)."""

import statistics


def read(run):
    if len(run.solve_times) < 10:
        return None
    return statistics.quantiles(run.solve_times, n=10,
                                method="inclusive")[-1] * 1e3
