"""``fit.launches_per_round``: kernel launches the host made in the
traced fit (the profiler's runtime launch calls), over its rounds."""


def read(ctx):
    s = ctx.get("trace")
    if s is None or not s.rounds:
        return None
    return s.launches / s.rounds
