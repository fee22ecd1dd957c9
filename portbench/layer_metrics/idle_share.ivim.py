"""Share of the traced window in which no operation ran on the device (the
ivim-slab-stream cell): the device layer under
``serving.engine.predict_volume``."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.window_s else None
