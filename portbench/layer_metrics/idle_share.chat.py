"""Share of the traced window in which no operation ran on the device (the
lm-chat-open cell): the device layer under ``BayesianLMServer.step``."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.window_s else None
