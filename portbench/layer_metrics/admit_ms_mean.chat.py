"""Mean length of the program's ``admit`` spans of LM requests in the
window: ``BayesianLMServer._admit``, its bucketed prefill
(``models.transformer.prefill`` through ``flash_attention``), the scatter
into the pool and the first token."""


def read(ctx):
    tl = ctx.tally
    begins = {e["span"]: e for e in tl["spans"]
              if e["kind"] == "begin" and e["name"] == "admit"
              and e["attrs"].get("kind") == "lm"}
    spans = [e["t"] - begins[e["span"]]["t"] for e in tl["spans"]
             if e["kind"] == "end" and e["span"] in begins
             and tl["t0"] < begins[e["span"]]["t"] and e["t"] <= tl["t1"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
