"""The paper's technique at LM scale: mask-based Bayesian *serving* with
per-token uncertainty, on any assigned architecture (reduced config).

    python -m repro_torch.examples.serve_uncertainty_lm \
        [--arch qwen2-1.5b] [--tokens 12] [--server] \
        [--trace-out trace.jsonl] [--metrics-out metrics.prom] [--device cpu]

Every request is evaluated under N fixed Masksembles masks (no runtime RNG);
the decode loop reports the relative uncertainty of each emitted token and
flags tokens above the threshold — the LM analogue of the paper's clinical
escalation pathway.

Default mode drives the one-shot engine (``serve_uncertain``: one fixed
batch to completion). ``--server`` drives the same requests through the
continuous-batching server instead — an admission queue feeding a
``N_masks x max_slots`` KV slot pool with fixed-shape steps — and prints
the serving metrics (tokens/s, latency percentiles, slot occupancy).

``--scan`` (with ``--server``) also submits a synthetic IVIM scan volume
into the SAME pool as a voxel-chunk work item (``submit_scan``): one slot,
one fused-moments chunk per engine step, sharing the LM requests' queue,
backpressure and escalation policy.

``--hosts N`` (with ``--server``) fronts N per-host pools with the
fault-tolerant multi-host router (``serving.router``): sticky round-robin
homes, cross-host spill, heartbeat health checks on a virtual clock, and
bounded retry/backoff failover. ``--chaos`` kills host 0 at router step 2
through the deterministic fault plan (``serving.faults``); the recovered
tokens come back identical anyway.

``--trace-out`` (with ``--server``) switches on span tracing
(``obs.trace``) and writes the request-lifecycle log as JSONL, which the
repository's trace verifier (``benchmarks/verify_obs.py``) reads;
``--metrics-out`` writes the telemetry registry as Prometheus text.

On the card the prefill runs the ``flash_attention`` kernel, each
posterior the ``moments`` kernel, the decode steps the ``fused_decode``
kernel where the architecture has a fused lowering, and ``--scan``'s
chunks the ``fused_plan`` kernel in moments mode.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.models.model import build_model
from repro_torch.serving import (BayesianLMServer, ServeConfig, ServerConfig,
                                 serve_uncertain)

__all__ = ["PROMPT_LEN", "SCAN_SHAPE", "prompts", "serve_oneshot",
           "serve_pool", "run", "main"]

#: Every prompt's length, and the scan volume's voxel grid.
PROMPT_LEN = 8
SCAN_SHAPE = (8, 8, 4)


def prompts(n: int, vocab: int) -> np.ndarray:
    """``n`` prompts of :data:`PROMPT_LEN` tokens from numpy seed 1."""
    return np.random.default_rng(1).integers(0, vocab, (n, PROMPT_LEN),
                                             dtype=np.int64)


def serve_oneshot(model, params, toks: np.ndarray, *, tokens: int = 12,
                  threshold: float = 0.35, device=None):
    """One fixed batch through ``serve_uncertain``: (generated tokens
    [B, T], rel-unc [B, T], flags [B, T])."""
    gen, unc, flags = serve_uncertain(
        model, params, torch.as_tensor(toks),
        ServeConfig(max_new_tokens=tokens, uncertainty_threshold=threshold),
        device=device)
    return gen[:, toks.shape[1]:], unc, flags


def _scan_plan(n_masks: int, device):
    """A random uIVIM-NET (torch seed 2) packed for serving, and a uniform
    random volume of :data:`SCAN_SHAPE` voxels (numpy seed 3)."""
    from repro_torch.ivim import model as ivim_model
    icfg = ivim_model.IvimConfig(n_masks=n_masks, scale=2.0)
    plan = ivim_model.pack_for_serving(ivim_model.init(
        icfg, torch.Generator().manual_seed(2), device=device))
    vol = np.random.default_rng(3).uniform(
        size=SCAN_SHAPE + (icfg.width,)).astype(np.float32)
    return plan, torch.as_tensor(vol, device=device)


def serve_pool(model, params, toks: np.ndarray, *, tokens: int = 12,
               threshold: float = 0.35, slots: int = 2, hosts: int = 1,
               chaos: bool = False, scan: bool = False, trace: bool = False,
               device=None) -> dict:
    """The requests through one server (``hosts`` 1) or ``hosts`` behind
    the router on a virtual clock advanced 1.0 a router step (host 0
    killed at step 2 with ``chaos``), with the scan beside them. Returns
    each request's final state, the scan's, the summary, and the server
    or router."""
    dev = device_lib.resolve(device)
    n_masks = model.cfg.mask_samples
    scfg = ServerConfig(max_slots=slots, max_prompt_len=PROMPT_LEN,
                        max_new_tokens=tokens,
                        uncertainty_threshold=threshold, trace=trace)
    clock = None
    if hosts > 1:
        from repro_torch.obs.trace import ManualClock
        from repro_torch.serving import (FaultEvent, FaultPlan, RouterConfig,
                                         ServingRouter)
        faults = FaultPlan(events=(FaultEvent(step=2, host=0,
                                              action="kill"),)) \
            if chaos else FaultPlan()
        clock = ManualClock()
        server = ServingRouter(
            model, params, scfg,
            RouterConfig(n_hosts=hosts, heartbeat_timeout_s=2.5,
                         max_retries=3),
            device=dev, faults=faults, clock=clock)
    else:
        server = BayesianLMServer(model, params, scfg, device=dev)
    rids = [server.submit(torch.as_tensor(p)) for p in toks]
    sid = None
    if scan:
        plan, vol = _scan_plan(n_masks, dev)
        sid = server.submit_scan(plan, vol.reshape(-1, vol.shape[-1]),
                                 chunk=64)
    if hosts > 1:
        summary = server.run(max_steps=10_000,
                             tick=lambda: clock.advance(1.0))
    else:
        summary = server.run()

    def final(rid):
        return server.result(rid).final if hosts > 1 else server.result(rid)

    return {"server": server, "requests": [final(r) for r in rids],
            "rids": rids, "scan": final(sid) if sid is not None else None,
            "scan_id": sid, "summary": summary}


def run(arch: str = "qwen2-1.5b", tokens: int = 12, n_masks: int = 4,
        threshold: float = 0.35, server: bool = False, requests: int = 4,
        slots: int = 2, hosts: int = 1, chaos: bool = False,
        scan: bool = False, trace: bool = False, device=None) -> dict:
    """The reference's reduced config of ``arch`` at ``n_masks`` masks,
    random weights from torch seed 0 on ``device`` (None -> the card),
    served one-shot (two prompts) or through the pool (``requests``
    prompts). Returns the config and what the mode returns."""
    dev = device_lib.resolve(device)
    cfg = registry.smoke_config(arch, mask_samples=n_masks)
    if not cfg.has_decode:
        raise SystemExit(f"{arch} is encoder-only; pick a decoder arch")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    if not server:
        gen, unc, flags = serve_oneshot(model, params,
                                        prompts(2, cfg.vocab_size),
                                        tokens=tokens, threshold=threshold,
                                        device=dev)
        return {"cfg": cfg, "tokens": gen, "uncertainty": unc,
                "flags": flags}
    out = serve_pool(model, params, prompts(requests, cfg.vocab_size),
                     tokens=tokens, threshold=threshold, slots=slots,
                     hosts=hosts, chaos=chaos, scan=scan, trace=trace,
                     device=dev)
    return {"cfg": cfg, **out}


def _print_request(i, tokens, uncs, flags, threshold):
    toks = " ".join(f"{int(t):4d}" for t in tokens)
    unc = " ".join(f"{float(u):4.2f}" for u in uncs)
    flg = " ".join("   ^" if bool(f) else "    " for f in flags)
    print(f"req {i}: tokens  {toks}")
    print(f"       rel-unc {unc}")
    if any(bool(f) for f in flags):
        print(f"               {flg}  <- above threshold "
              f"{threshold} (escalate)")


def _check_flags(args) -> None:
    if args.scan and not args.server:
        raise SystemExit("--scan needs --server (the scan rides the pool)")
    if args.hosts > 1 and not args.server:
        raise SystemExit("--hosts needs --server (the router fronts pools)")
    if args.chaos and args.hosts < 2:
        raise SystemExit("--chaos needs --hosts >= 2 (a surviving host "
                         "must pick up the dead host's work)")
    if (args.trace_out or args.metrics_out) and not args.server:
        raise SystemExit("--trace-out/--metrics-out need --server (the "
                         "one-shot engine has no request lifecycle)")


def _print_pool(args, r) -> None:
    use_router = args.hosts > 1
    if args.chaos:
        print(f"chaos: host 0 goes silent at router step 2 "
              f"({args.hosts - 1} host(s) survive)")
    if use_router:
        print(f"router: {args.hosts} hosts x {args.slots} slots, "
              f"heartbeat timeout 2.5 virtual s")
    if r["scan"] is not None:
        print(f"scan: {SCAN_SHAPE} IVIM volume "
              f"({int(np.prod(SCAN_SHAPE))} voxels) as one voxel-chunk "
              f"work item")
    flagged = 0
    for i, st in enumerate(r["requests"]):
        _print_request(i, st.generated, st.uncertainty, st.flags,
                       args.threshold)
        flagged += sum(st.flags)
    print(f"\nflagged {flagged}/"
          f"{sum(len(st.generated) for st in r['requests'])} tokens"
          f" for review")
    st = r["scan"]
    if st is not None:
        mean, std = st.scan_moments()
        rel = (std / mean.abs().clamp_min(1e-12)).float().cpu().numpy()
        print(f"\n-- scan (req {r['scan_id']}) --")
        print(f"chunks    {len(st.chunk_results)} "
              f"({sum(st.flags)} flagged above {args.threshold}, "
              f"{st.preempts} preemptions)")
        if not use_router:      # per-request timelines are per-host
            tl = r["server"].metrics.timelines
            sid = r["scan_id"]
            print(f"latency   {tl[sid].latency * 1e3:.1f} ms "
                  f"(queue wait {tl[sid].queue_wait * 1e3:.1f} ms)")
            lm_lat = [tl[rid].latency for rid in r["rids"]]
            print(f"lm latency alongside   p50 "
                  f"{np.percentile(lm_lat, 50) * 1e3:.1f} ms")
        print(f"voxel rel-unc   mean {rel.mean():.3f}   max {rel.max():.3f}")
    print(f"\n-- serving metrics ({args.slots} slots x "
          f"{args.n_masks} mask rows each) --")
    print(r["summary"].format())
    if args.trace_out:
        from repro_torch.obs import trace as obs_trace
        n = obs_trace.TRACER.export_jsonl(args.trace_out)
        print(f"\nwrote {n} trace records -> {args.trace_out}  "
              f"(verify: python -m benchmarks.verify_obs "
              f"--trace {args.trace_out})")
    if args.metrics_out:
        from repro_torch.obs import export as obs_export
        with open(args.metrics_out, "w") as f:
            f.write(obs_export.prometheus_text())
        print(f"wrote metrics exposition -> {args.metrics_out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--n-masks", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=0.35)
    ap.add_argument("--server", action="store_true",
                    help="route requests through the continuous-batching "
                         "server (queue -> slots -> mask groups)")
    ap.add_argument("--requests", type=int, default=4,
                    help="request count in --server mode")
    ap.add_argument("--slots", type=int, default=2,
                    help="KV slot-pool size in --server mode")
    ap.add_argument("--hosts", type=int, default=1,
                    help="front N per-host pools with the fault-tolerant "
                         "router (--server mode; 1 = single server)")
    ap.add_argument("--chaos", action="store_true",
                    help="script a host kill mid-run (--hosts > 1): the "
                         "router detects the death by heartbeat, resubmits "
                         "the work, remeshes — results are unchanged")
    ap.add_argument("--scan", action="store_true",
                    help="also submit a synthetic IVIM scan volume into the "
                         "same pool (--server mode): voxel chunks and LM "
                         "tokens share slots, queue and escalation policy")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="(--server mode) enable span tracing and write the "
                         "request-lifecycle event log as JSONL")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="(--server mode) write the telemetry registry as "
                         "Prometheus text exposition after the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    _check_flags(args)
    print(f"arch={args.arch} (reduced), N={args.n_masks} fixed masks")
    r = run(args.arch, args.tokens, args.n_masks, args.threshold,
            args.server, args.requests, args.slots, args.hosts, args.chaos,
            args.scan, bool(args.trace_out), args.device)
    if args.server:
        _print_pool(args, r)
        return 0
    for i in range(r["tokens"].shape[0]):
        _print_request(i, r["tokens"][i], r["uncertainty"][i], r["flags"][i],
                       args.threshold)
    print(f"\nflagged {int(r['flags'].sum())}/{r['flags'].numel()} tokens "
          f"for review")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
