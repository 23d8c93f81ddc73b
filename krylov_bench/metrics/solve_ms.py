"""``solve_ms``: the window's elapsed time over the solves in it (host clock,
each solve ended by a synchronisation)."""


def read(run):
    if not run.solve_times:
        return None
    return run.window_s / len(run.solve_times) * 1e3
