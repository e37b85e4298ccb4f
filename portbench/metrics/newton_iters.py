"""Newton iterations per steady solve (ForwardResult.counts)."""


def read(run):
    if not run.requests:
        return None
    return sum(r["counts"].get("newton_iters", 0)
               for r in run.requests) / len(run.requests)
