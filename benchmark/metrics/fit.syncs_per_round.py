"""``fit.syncs_per_round``: calls in the traced fit that waited on the
device (stream, device and event synchronisations, blocking copies),
over its rounds."""


def read(ctx):
    s = ctx.get("trace")
    if s is None or not s.rounds:
        return None
    return s.syncs / s.rounds
