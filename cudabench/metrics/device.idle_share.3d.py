"""1 - the union of the device's operations over the traced window, %."""


def read(ctx):
    idle = ctx.trace["idle_share"]
    return None if idle is None else 100.0 * idle
