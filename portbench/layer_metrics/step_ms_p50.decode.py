"""Median length of the program's ``step`` spans in the window: the
decode part of ``BayesianLMServer.step`` (token and position vectors, the
``core.plan`` fused runner and its cache commit, the argmax read back);
admission runs before the span opens."""

import numpy as np


def read(ctx):
    tl = ctx.tally
    begins = {e["span"]: e["t"] for e in tl["spans"]
              if e["kind"] == "begin" and e["name"] == "step"}
    spans = [e["t"] - begins[e["span"]] for e in tl["spans"]
             if e["kind"] == "end" and e["span"] in begins
             and tl["t0"] < begins[e["span"]] and e["t"] <= tl["t1"]]
    return 1e3 * float(np.percentile(spans, 50)) if spans else None
