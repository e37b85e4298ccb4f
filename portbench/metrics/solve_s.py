"""Time to a converged steady solve per request: the window, up to the
end of its last request, over the solves it completed."""


def read(run):
    if not run.requests:
        return None
    return run.window_s / len(run.requests)
