"""95th percentile of the admission queue's wait: from each request's
scheduled arrival to the start of the program's ``admit`` span for it
(``BayesianLMServer._admit``), over the LM admissions that start in the
window. Both times are on ``obs.trace.default_clock``."""

import numpy as np


def read(ctx):
    tl = ctx.tally
    waits = [e["t"] - tl["dues"][e["attrs"]["req_id"]]
             for e in tl["spans"]
             if e["kind"] == "begin" and e["name"] == "admit"
             and e["attrs"].get("kind") == "lm"
             and not e["attrs"].get("resumed")
             and e["attrs"]["req_id"] in tl["dues"]
             and tl["t0"] < e["t"] <= tl["t1"]]
    return 1e3 * float(np.percentile(waits, 95)) if waits else None
