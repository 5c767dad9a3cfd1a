"""Entries committed per group-round over the window: the sum over groups
of the commit advance (per-group commit maxima snapshot on the device at
the window's start and end) over groups times rounds.  Cells whose mix
proposes nothing read nothing."""


def read(ctx):
    if not ctx["cell"].proposes or not ctx["rounds"]:
        return None
    return ctx["entries"] / (ctx["groups"] * ctx["rounds"])
