"""Driver of the LM cells: ``serving.server.BayesianLMServer`` under a
traffic mix.

Set-up draws the weights on the device from the seed, builds the server
(fused decode required), warms the prefill buckets the traffic's prompt
lengths fall into and the decode runner, then fills the pool: a closed
loop admits its clients' first requests (their outputs cut to a
stratified share, so they finish at staggered times), an open loop runs
its arrivals for ``prime_s`` seconds. The window then drives ``submit`` /
``step`` and stamps each token at the return of the step that made it.

The check runs after the window, on a sample of finished requests drawn
from the seed with the longest among them: the plain fp32 reference over
prompt and served tokens, the widest gap by which a served token's mean
log-probability lies below the reference's best, and the relative
uncertainty against the reference's (each token's difference over the
larger of its reference value and the sample's median, so tokens whose
masks all but agree do not divide by nearly nothing). The reference is
the module of ``reference/`` that the configuration file names.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

from portbench import harness, inputs, traffic
from portbench.reference import ivim as ivim_ref

__all__ = ["dims", "setup"]


def dims(config: dict) -> dict:
    """The configuration file's published keys as the counts and the
    reference name them, with the block this driver runs (Qwen2's:
    RMSNorm, biases on q, k and v)."""
    return {"n_layers": config["num_hidden_layers"],
            "d_model": config["hidden_size"],
            "n_heads": config["num_attention_heads"],
            "n_kv_heads": config["num_key_value_heads"],
            "head_dim": config["hidden_size"] // config["num_attention_heads"],
            "d_ff": config["intermediate_size"],
            "vocab_size": config["vocab_size"],
            "rope_theta": config["rope_theta"],
            "norm": "rmsnorm", "qkv_bias": True,
            "norm_eps": config["rms_norm_eps"],
            "dtype": config["torch_dtype"],
            "mask_samples": config["mask_samples"],
            "mask_scale": config["mask_scale"],
            "mask_seed": config["mask_seed"]}


def build_model(d: dict):
    """The program's model of ``dims``: a dense Qwen2 block."""
    from repro_torch.models import model as lm_model
    return lm_model.build_model(_model_config(d))


def _model_config(d: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        arch_id="portbench-decoder", family="dense",
        n_layers=d["n_layers"], d_model=d["d_model"], n_heads=d["n_heads"],
        n_kv_heads=d["n_kv_heads"], head_dim=d["head_dim"], d_ff=d["d_ff"],
        vocab_size=d["vocab_size"], norm=d["norm"], activation="silu",
        qkv_bias=d["qkv_bias"], rope_theta=d["rope_theta"],
        mask_samples=d["mask_samples"], mask_scale=d["mask_scale"],
        mask_seed=d["mask_seed"], dtype=inputs.DTYPES[d["dtype"]])


def program_params(raw: dict) -> dict:
    """The benchmark's weights in the program's parameter tree (the same
    tensors, no copy but the masks' stack)."""
    nl = raw["wq"].shape[0]
    dt = raw["wq"].dtype
    attn = {k: {"w": raw[f"w{k}"], "b": raw[f"b{k}"]} for k in "qkv"}
    block = {"norm1": {"scale": raw["ln1_w"]},
             "attn": {**{f"w{k}": v for k, v in attn.items()},
                      "wo": {"w": raw["wo"]}},
             "norm2": {"scale": raw["ln2_w"]},
             "ffn": {"wg": {"w": raw["wg"]}, "wu": {"w": raw["wu"]},
                     "wd": {"w": raw["wd"]},
                     "masks": raw["masks"].to(dt)[None].repeat(nl, 1, 1)}}
    return {"segments": [{"b0": block}],
            "embed": {"embed": raw["embed"],
                      "unembed": {"w": raw["unembed"]}},
            "final_norm": {"scale": raw["norm_w"]}}


@dataclasses.dataclass
class _Req:
    """The benchmark's record of one LM request."""
    due: float
    prompt: np.ndarray
    max_new: int
    client: int | None
    times: list = dataclasses.field(default_factory=list)
    tokens: tuple = ()
    unc: tuple = ()
    done: bool = False


def window_metrics(records, t0: float, t1: float):
    """The window [t0, t1]'s LM end-to-end metrics from every request's
    record (``due``: its scheduled arrival; ``times``: the return of the
    step that made each of its tokens): decode tokens/s over all tokens
    made in the window; TTFT p95 over every request first answered in it,
    from its due time; ITL p95 over every gap between consecutive tokens
    both made in it. Returns (metrics, ttft, itl, tokens)."""
    ttft, itl, tokens = [], [], 0
    for rec in records:
        times = rec.times
        if times and t0 < times[0] <= t1:
            ttft.append(times[0] - rec.due)
        for a, b in zip(times, times[1:]):
            if t0 < a and b <= t1:
                itl.append(b - a)
        tokens += sum(1 for x in times if t0 < x <= t1)
    e2e = {"decode_tokens_per_s": tokens / (t1 - t0)}
    if ttft:
        e2e["ttft_p95_ms"] = 1e3 * harness.pct(ttft, 95)
    if itl:
        e2e["itl_p95_ms"] = 1e3 * harness.pct(itl, 95)
    return e2e, ttft, itl, tokens


class Session:
    """One run of an LM cell (see the module docstring)."""

    def __init__(self, cell: dict, config: dict, seed: int,
                 device: torch.device, trace: bool, run_seconds: float):
        from repro_torch.obs import profile as obs_profile
        from repro_torch.obs import trace as obs_trace
        from repro_torch.serving import server as server_lib
        self.cell, self.seed, self.device = cell, seed, device
        self.dims = dims(config)
        self.ref = importlib.import_module(
            f"portbench.reference.{config['reference']}")
        self.server_lib = server_lib
        self.ranges = harness.HostRanges(trace)
        if trace:
            obs_trace.TRACER.configure(capacity=1 << 22)
            obs_trace.TRACER.enable()
            obs_profile.enable()
        self.tracer = obs_trace.TRACER
        tr = cell["traffic"]
        self.n_masks = self.dims["mask_samples"]
        self.setup_parts: dict[str, float] = {}
        mark = harness.Marks(self.setup_parts, device)
        self.model = build_model(self.dims)
        self.raw = inputs.lm_raw(self.dims, seed, device)
        mark("weights")
        params = program_params(self.raw)
        mark("program_tree")
        scfg = server_lib.ServerConfig(
            max_slots=cell["server"]["max_slots"],
            max_queue=cell["server"]["max_queue"],
            max_prompt_len=cell["server"]["max_prompt_len"],
            max_new_tokens=cell["server"]["max_new_tokens"],
            escalation_policy="flag", fused=True)
        self.server = server_lib.BayesianLMServer(self.model, params, scfg,
                                                  device=device)
        del params
        mark("server")
        self.run_seconds = run_seconds
        self.requests = traffic.lm_requests(tr, self.dims["vocab_size"],
                                            seed, run_seconds)
        self.next_req = 0
        self.records: dict[int, _Req] = {}
        self.active: set[int] = set()
        self.steps: list = []          # in-window (positions, prefill lens)
        mark("traffic")
        self._warm(tr)
        mark("warm")
        self._fill(tr)
        mark("fill")

    # ---- set-up ------------------------------------------------------------
    def _warm(self, tr: dict) -> None:
        """Every prefill bucket the traffic's prompt lengths fall into and
        the decode runner; then an empty pool."""
        from repro_torch.core import plan as plan_lib
        srv = self.server
        max_seq = srv.cfg.max_seq
        lo, hi = tr["prompt"]["min"], tr["prompt"]["max"]
        longest: dict[int, int] = {}
        for n in range(lo, hi + 1):
            longest[plan_lib.prefill_bucket(n, max_seq)] = n
        g = np.random.default_rng([self.seed, 4])
        for n in sorted(longest.values()):
            srv.submit(g.integers(0, self.dims["vocab_size"], n),
                       max_new_tokens=2)
        while srv.step():
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for rid in list(srv.states):
            srv.pop_result(rid)

    def _fill(self, tr: dict) -> None:
        self.t_base = harness.clock()
        if tr["loop"] == "closed":
            c = tr["clients"]
            first = traffic.residual_outputs(
                [r.max_new_tokens for r in self.requests[:c]], self.seed)
            for client in range(c):
                self._submit_lm(self.t_base, client, max_new=first[client])
            self.server.step()
            self._harvest(harness.clock(), None)
        else:
            self.arrivals = self.t_base + traffic.arrivals(
                tr, self.seed, self.run_seconds)
            self._loop(self.t_base + float(tr.get("prime_s", 0.0)), None)

    # ---- traffic -----------------------------------------------------------
    def _submit_lm(self, due: float, client, max_new=None, count=None):
        if self.next_req >= len(self.requests):
            raise RuntimeError("the cell's request list ran out: raise "
                               "traffic.cycles")
        r = self.requests[self.next_req]
        self.next_req += 1
        rec = _Req(due, r.tokens, max_new or r.max_new_tokens, client)
        if count is not None:
            count["attempted"] += 1
        try:
            with self.ranges.range("submit"):
                rid = self.server.submit(rec.prompt,
                                         max_new_tokens=rec.max_new)
        except self.server_lib.QueueFullError:
            if count is not None:
                count["failed"] += 1
            return
        self.records[rid] = rec
        self.active.add(rid)

    def _harvest(self, t: float, win) -> None:
        """Fold one step's results in at its return time ``t``; ``win``
        collects the window's tallies (None outside the window)."""
        srv = self.server
        positions, prefills = [], []
        for rid in list(self.active):
            st = srv.result(rid)
            rec = self.records[rid]
            n = len(st.generated)
            if n > len(rec.times):
                if not rec.times:
                    prefills.append(len(rec.prompt))
                positions += [len(rec.prompt) + n - 1] * self.n_masks
                rec.times += [t] * (n - len(rec.times))
            if st.status in ("done", "escalated"):
                st = srv.pop_result(rid)
                rec.tokens, rec.unc = tuple(st.generated), tuple(st.uncertainty)
                rec.done = True
                self.active.discard(rid)
                if rec.client is not None:
                    self._submit_lm(t, rec.client, count=win)
        if win is not None:
            self.steps.append((positions, prefills))
            win["queue"].append(srv.queue_depth)

    def _loop(self, until: float, win) -> float:
        """Send due arrivals and step until ``until``; returns the later of
        the last step's return and the loop's end."""
        srv = self.server
        t_last = harness.clock()
        open_loop = self.cell["traffic"]["loop"] == "open"
        while True:
            now = harness.clock()
            if now >= until:
                return max(t_last, now)
            if open_loop:
                while (self.next_req < len(self.arrivals)
                       and self.arrivals[self.next_req] <= now):
                    self._submit_lm(float(self.arrivals[self.next_req]),
                                    None, count=win)
            if not (srv.queue_depth or srv.occupied_slots):
                nxt = (self.arrivals[self.next_req] if open_loop
                       and self.next_req < len(self.arrivals) else until)
                time.sleep(max(0.0, min(nxt, until) - now))
                continue
            with self.ranges.range("step"):
                srv.step()
            t_last = harness.clock()
            self._harvest(t_last, win)

    # ---- the window --------------------------------------------------------
    def run(self, seconds: float) -> dict:
        win = {"attempted": 0, "failed": 0, "queue": []}
        self.tracer.clear()
        t0 = harness.clock()
        with self.ranges.range("window"):
            t1 = self._loop(t0 + seconds, win)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.t0, self.t1 = t0, t1
        span = t1 - t0
        e2e, ttft, itl, tokens = window_metrics(self.records.values(), t0,
                                                t1)
        self.window = {"window_s": span, "ttft": ttft, "itl": itl,
                       "tokens": tokens, **win}
        return {"e2e": e2e, "attempted": win["attempted"],
                "failed": win["failed"]}

    def tally(self) -> dict:
        """What the per-layer readers read besides the trace."""
        spans = [e for e in self.tracer.events()
                 if e["kind"] in ("begin", "end")]
        return {"kind": "lm", "dims": self.dims, "n_masks": self.n_masks,
                "steps": self.steps, "spans": spans, "t0": self.t0,
                "t1": self.t1,
                "dues": {rid: r.due for rid, r in self.records.items()},
                **self.window}

    def release(self) -> None:
        """Free the program's state (server, pool, step closures' views)."""
        self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ---------------------------------------------------------
    def _sample(self) -> list[_Req]:
        done = [r for r in self.records.values() if r.done and r.tokens]
        if not done:
            return []
        k = int(self.cell["check"]["lm_requests"])
        longest = max(done, key=lambda r: len(r.prompt) + len(r.tokens))
        rest = [r for r in done if r is not longest]
        g = np.random.default_rng([self.seed, 5])
        pick = g.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
        return [longest] + [rest[i] for i in sorted(pick)]

    def _layer(self, li: int) -> dict:
        return {k: self.raw[k][li].float() for k in self.ref.LAYER_KEYS}

    def check(self, control: bool = False) -> dict:
        """The numbers compared (see the module docstring); with
        ``control``, the same numbers for the fp8 control put in the
        program's place (under ``control.*``)."""
        out: dict = {}
        sample = self._sample()
        if not sample:
            return {"lm_requests_checked": 0}
        head = {"norm_w": self.raw["norm_w"].float(),
                "unembed": self.raw["unembed"].float()}
        embed = self.raw["embed"]
        gaps, rel_errs, cgaps, crel = [], [], [], []
        with ivim_ref.fp32_products():
            for rec in sample:
                seq = np.concatenate([rec.prompt,
                                      np.asarray(rec.tokens[:-1], np.int32)])
                toks = torch.as_tensor(seq, device=self.device)
                first = len(rec.prompt) - 1
                mean, std = self.ref.posterior(self.dims, self._layer, embed,
                                             head, self.raw["masks"], toks,
                                             first)
                served = torch.as_tensor(rec.tokens, device=self.device
                                         ).long()[:, None]
                best = mean.max(-1).values
                m_s = mean.gather(-1, served)[:, 0]
                gaps.append(float((best - m_s).max()))
                rel_ref = std.gather(-1, served)[:, 0] / m_s.abs()
                rel_p = torch.as_tensor(rec.unc, device=self.device)
                floor = rel_ref.median()
                rel_errs.append(float(((rel_p - rel_ref).abs()
                                       / rel_ref.clamp_min(floor)).max()))
                if control:
                    cm, cs = self.ref.posterior(self.dims, self._layer, embed,
                                              head, self.raw["masks"], toks,
                                              first, quant="fp8")
                    ctok = cm.argmax(-1, keepdim=True)
                    cgaps.append(float((best - mean.gather(-1, ctok)[:, 0]
                                        ).max()))
                    c_rel = cs.gather(-1, served)[:, 0] / \
                        cm.gather(-1, served)[:, 0].abs()
                    crel.append(float(((c_rel - rel_ref).abs()
                                       / rel_ref.clamp_min(floor)).max()))
                    del cm, cs
                del mean, std
        out["gap_max_nats"] = max(gaps)
        out["rel_unc_err"] = max(rel_errs)
        out["lm_requests_checked"] = len(sample)
        out["lm_tokens_checked"] = sum(len(r.tokens) for r in sample)
        if control:
            out["control.gap_max_nats"] = max(cgaps)
            out["control.rel_unc_err"] = max(crel)
        return out


def setup(cell: dict, config: dict, seed: int, device: torch.device,
          trace: bool, run_seconds: float) -> Session:
    return Session(cell, config, seed, device, trace, run_seconds)
