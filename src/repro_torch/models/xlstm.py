"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM + sLSTM (the port's
twin of ``repro.models.xlstm``).

mLSTM — matrix-memory LSTM with exponential gating:
    i_t = exp(i~_t),  f_t = sigmoid(f~_t)
    C_t = f_t C_{t-1} + i_t k_t v_t^T        (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t^T C_t) / max(|q_t . n_t|, exp(-m_t))   (m_t = log-scale stabilizer)

Prefill runs the reference's chunkwise-parallel form: within a chunk of
``chunk_size`` positions a masked [C, C] product, across chunks a carried
(C, n, m) state, both stabilised in log space by the running max m.
Decode is the O(1) recurrence.

sLSTM — scalar-memory LSTM with exponential gating and a block-diagonal
(per-head) recurrent matrix; inherently sequential (h_{t-1} feeds the
gates): a loop over time.

Gates, stabilisers and the carried state are fp32 whatever the model's
dtype. The parameter and state layouts are the reference's, so its
checkpoints carry over (``transformer.params_from_jax``). Neither block
reaches a kernel of its own: the reference computes both outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = dict[str, Any]

__all__ = ["NEG", "mlstm_parallel", "mlstm_step",
           "mlstm_block_init", "mlstm_block_apply", "mlstm_block_step",
           "mlstm_state_init", "mlstm_state_specs",
           "slstm_block_init", "slstm_block_apply", "slstm_block_step",
           "slstm_state_init", "slstm_state_specs", "time_scan"]

#: The stabiliser ``m``'s empty state: the first step's max takes its gate.
NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------------


def _mlstm_chunk(q, k, v, igate, fgate, carry, *, eps=1e-6):
    """One chunk. q/k/v [B,H,C,dh] (k pre-scaled by 1/sqrt(dh)),
    igate/fgate preactivations [B,H,C]; carry = (C_state [B,H,dh,dh],
    n_state [B,H,dh], m_state [B,H]).

    With F_j = cumsum(log sigmoid(f~))_j (inclusive) and a_t = i~_t - F_t:
      per-position stabilizer  m*_j = F_j + M_j,  M_j = max(m_prev, cummax a)
      intra weights            D_jt = exp(a_t - M_j) [t <= j]
      inter coefficient        c_j  = exp(m_prev - M_j)
      state update             C' = e^{m_prev - M_L} C + sum_t e^{a_t - M_L} k_t v_t^T
                               m' = F_L + M_L
    (the F_j terms cancel inside D — only the cummax survives).
    """
    c_state, n_state, m_state = carry
    # DTensor has no rule for log_sigmoid's backward: the local shards
    lf = layers.local_pointwise(F.logsigmoid, fgate.float())     # [B,H,C]
    fc = torch.cumsum(lf, -1)
    a = igate.float() - fc                                       # [B,H,C]
    g = torch.cummax(a, 2).values
    m = torch.maximum(m_state[..., None], g)                     # [B,H,C]

    qf, kf, vf = q.float(), k.float(), v.float()

    s = torch.einsum("bhqd,bhtd->bhqt", qf, kf)                  # [B,H,C,C]
    cc = q.shape[2]
    tri = torch.tril(torch.ones((cc, cc), dtype=torch.bool,
                                device=q.device))
    d_w = torch.where(tri, torch.exp(a[:, :, None, :] - m[..., None]), 0.0)
    sw = s * d_w                                                 # weighted
    num_intra = torch.einsum("bhqt,bhtd->bhqd", sw, vf)
    den_intra = sw.sum(-1)                                       # [B,H,C]

    c_j = torch.exp(m_state[..., None] - m)                      # [B,H,C]
    num_inter = torch.einsum("bhqd,bhde->bhqe", qf, c_state) * c_j[..., None]
    den_inter = torch.einsum("bhqd,bhd->bhq", qf, n_state) * c_j

    m_star = fc + m
    den = torch.maximum((den_intra + den_inter).abs(),
                        torch.exp(-m_star)) + eps
    h = (num_intra + num_inter) / den[..., None]                 # [B,H,C,dh]

    # ---- carry update -------------------------------------------------------
    m_last = m[..., -1]                                          # [B,H]
    w_t = torch.exp(a - m_last[..., None])                       # [B,H,C]
    decay = torch.exp(m_state - m_last)                          # [B,H]
    c_new = (decay[..., None, None] * c_state
             + torch.einsum("bht,bhtd,bhte->bhde", w_t, kf, vf))
    n_new = decay[..., None] * n_state + torch.einsum("bht,bhtd->bhd",
                                                      w_t, kf)
    m_new = fc[..., -1] + m_last
    return h, (c_new, n_new, m_new)


def mlstm_parallel(q, k, v, igate, fgate, carry, chunk: int):
    """Full-sequence chunkwise mLSTM. q/k/v [B,H,S,dh] -> (h fp32, carry).
    A length that ``chunk`` does not divide runs as one chunk."""
    s = q.shape[2]
    if s % chunk:
        chunk = s
    outs = []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        out, carry = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                  igate[..., sl], fgate[..., sl], carry)
        outs.append(out)
    return torch.cat(outs, 2), carry


def mlstm_step(q, k, v, igate, fgate, carry, *, eps=1e-6):
    """O(1) decode step. q/k/v [B,H,dh], gates [B,H]."""
    c_state, n_state, m_state = carry
    lf = F.logsigmoid(fgate.float())
    ig = igate.float()
    m_new = torch.maximum(lf + m_state, ig)
    fw = torch.exp(lf + m_state - m_new)
    iw = torch.exp(ig - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    c_new = (fw[..., None, None] * c_state
             + iw[..., None, None] * kf[..., :, None] * vf[..., None, :])
    n_new = fw[..., None] * n_state + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                        torch.exp(-m_new)) + eps
    return num / den[..., None], (c_new, n_new, m_new)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def _block_diag_init(gen: torch.Generator, h: int, din: int, dout: int,
                     dtype) -> torch.Tensor:
    return layers._randn(gen, (h, din, dout), 1.0 / math.sqrt(din), dtype)


def mlstm_block_init(gen: torch.Generator, cfg, dtype) -> Params:
    d = cfg.d_model
    pd = int(cfg.xlstm_pf * d)
    h = cfg.n_heads
    pdh = pd // h
    dev = gen.device
    p: Params = {
        "norm": layers.norm_init(d, "rmsnorm", dtype, dev),
        "wu": layers.dense_init(gen, d, pd, dtype),       # up (cell input)
        "wg": layers.dense_init(gen, d, pd, dtype),       # up (output gate)
        "wq": _block_diag_init(gen, h, pdh, pdh, dtype),  # per-head q/k/v
        "wk": _block_diag_init(gen, h, pdh, pdh, dtype),
        "wv": _block_diag_init(gen, h, pdh, pdh, dtype),
        "wif": layers.dense_init(gen, d, 2 * h, dtype, bias=True),
        "hnorm": layers.norm_init(pd, "rmsnorm", dtype, dev),
        "wd": layers.dense_init(gen, pd, d, dtype,
                                scale=1.0 / math.sqrt(pd)),
    }
    if cfg.bayesian:
        p["masks"] = layers.mask_table(cfg, pd, dtype, dev)
    return p


def _mlstm_qkv(p: Params, x: torch.Tensor, cfg):
    """x [B,S,D] -> q/k/v [B,H,S,pdh], gates [B,H,S]."""
    b, s, _ = x.shape
    h = cfg.n_heads
    z = layers.dense(p["wu"], x)                        # [B,S,pd]
    zh = layers.split_fit(z, 2, h).reshape(b, s, h, -1).transpose(1, 2)
    q = torch.einsum("bhsd,hde->bhse", zh, p["wq"])
    k = torch.einsum("bhsd,hde->bhse", zh, p["wk"]) / math.sqrt(zh.shape[-1])
    v = torch.einsum("bhsd,hde->bhse", zh, p["wv"])
    gates = layers.dense(p["wif"], x)                   # [B,S,2H]
    ig = gates[..., :h].transpose(1, 2)                 # [B,H,S]
    fg = gates[..., h:].transpose(1, 2) + 3.0           # forget bias -> ~1
    return q, k, v, ig, fg


def _mlstm_out(p: Params, x, h_cell, cfg, mask_ids):
    b, hh, s, pdh = h_cell.shape
    hm = h_cell.transpose(1, 2).reshape(b, s, hh * pdh)
    hm = layers.norm_apply(p["hnorm"], hm, "rmsnorm")
    hm = hm * F.silu(layers.dense(p["wg"], x))
    if mask_ids is not None and "masks" in p:
        hm = hm * p["masks"][mask_ids][:, None, :]
    return layers.dense(p["wd"], hm)


def mlstm_state_specs(batch: int, cfg, dtype) -> dict[str, tuple]:
    """``{leaf: (shape, dtype)}`` of one block's state, all fp32."""
    h = cfg.n_heads
    pdh = int(cfg.xlstm_pf * cfg.d_model) // h
    return {"C": ((batch, h, pdh, pdh), torch.float32),
            "n": ((batch, h, pdh), torch.float32),
            "m": ((batch, h), torch.float32)}


def _state_init(specs: dict, device) -> Params:
    return {name: torch.full(shape, NEG if name == "m" else 0.0, dtype=dt,
                             device=device)
            for name, (shape, dt) in specs.items()}


def mlstm_state_init(batch: int, cfg, dtype, device=None) -> Params:
    """The empty state: C and n zero, m at :data:`NEG`."""
    return _state_init(mlstm_state_specs(batch, cfg, dtype), device)


def mlstm_block_apply(p: Params, x: torch.Tensor, cfg, mask_ids=None
                      ) -> tuple[torch.Tensor, Params]:
    """Prefill: x [B,S,D] -> (y, final state). Residual added by caller."""
    xn = layers.norm_apply(p["norm"], x, "rmsnorm")
    q, k, v, ig, fg = _mlstm_qkv(p, xn, cfg)
    st = mlstm_state_init(x.shape[0], cfg, x.dtype, x.device)
    h_cell, (c, n, m) = mlstm_parallel(q, k, v, ig, fg,
                                       (st["C"], st["n"], st["m"]),
                                       cfg.chunk_size)
    y = _mlstm_out(p, xn, h_cell.to(x.dtype), cfg, mask_ids)
    return y, {"C": c, "n": n, "m": m}


def mlstm_block_step(p: Params, x: torch.Tensor, state: Params, cfg,
                     mask_ids=None) -> tuple[torch.Tensor, Params]:
    """Decode: x [B,D] -> (y [B,D], new state)."""
    xn = layers.norm_apply(p["norm"], x[:, None, :], "rmsnorm")
    q, k, v, ig, fg = _mlstm_qkv(p, xn, cfg)
    h_cell, (c, n, m) = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   ig[:, :, 0], fg[:, :, 0],
                                   (state["C"], state["n"], state["m"]))
    y = _mlstm_out(p, xn, h_cell[:, :, None, :].to(x.dtype), cfg, mask_ids)
    return y[:, 0, :], {"C": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM — scalar memory, sequential
# ---------------------------------------------------------------------------


def slstm_block_init(gen: torch.Generator, cfg, dtype) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    dev = gen.device
    p: Params = {
        "norm": layers.norm_init(d, "rmsnorm", dtype, dev),
        # 4 gate preactivations from x: z, i, f, o
        "wzifo": layers.dense_init(gen, d, 4 * d, dtype, bias=True),
        # block-diagonal recurrent matrices per head, for all 4 gates
        "rzifo": _block_diag_init(gen, h, dh, 4 * dh, dtype),
        "hnorm": layers.norm_init(d, "rmsnorm", dtype, dev),
        "wd": layers.dense_init(gen, d, d, dtype),
    }
    if cfg.bayesian:
        p["masks"] = layers.mask_table(cfg, d, dtype, dev)
    return p


def slstm_state_specs(batch: int, cfg, dtype) -> dict[str, tuple]:
    """``{leaf: (shape, dtype)}`` of one block's state, all fp32."""
    return {name: ((batch, cfg.d_model), torch.float32)
            for name in ("c", "n", "h", "m")}


def slstm_state_init(batch: int, cfg, dtype, device=None) -> Params:
    """The empty state: c, n and h zero, m at :data:`NEG`."""
    return _state_init(slstm_state_specs(batch, cfg, dtype), device)


def _slstm_cell(rz: torch.Tensor, pre_x: torch.Tensor, state: Params, cfg):
    """One timestep. rz the recurrent matrices ``rzifo``; pre_x [B, 4D]
    (input preactivations); state fp32."""
    b = pre_x.shape[0]
    d = cfg.d_model
    h = cfg.n_heads
    hp = layers.split_fit(state["h"], 1, h).reshape(b, h, d // h).to(
        rz.dtype)
    rec = torch.einsum("bhd,hde->bhe", hp, rz).reshape(b, 4 * d)
    pre = (pre_x + rec).float()
    z, i, f, o = torch.split(pre, d, -1)
    # DTensor has no rule for log_sigmoid's backward: the local shards
    lf = layers.local_pointwise(F.logsigmoid, f)
    m_new = torch.maximum(lf + state["m"], i)
    iw = torch.exp(i - m_new)
    fw = torch.exp(lf + state["m"] - m_new)
    c_new = fw * state["c"] + iw * torch.tanh(z)
    n_new = fw * state["n"] + iw
    h_new = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def time_scan(cell, weight: torch.Tensor, state: Params, xs: torch.Tensor
              ) -> tuple[torch.Tensor, Params]:
    """``cell(weight, x_t, state) -> state`` stepped over dim 1 of ``xs``
    from ``state``: (every step's ``h`` stacked on dim 1, the last state).
    The counterpart of the reference's ``lax.scan``, and one helper so that
    ``launch.dryrun`` can count one step and multiply. ``unbind`` hands out
    the steps' inputs: its backward is one stack, where indexing's would
    write a zero [B, S, 4D] gradient for every step."""
    hs = []
    for x_t in xs.unbind(1):
        state = cell(weight, x_t, state)
        hs.append(state["h"])
    return torch.stack(hs, 1), state


def slstm_block_apply(p: Params, x: torch.Tensor, cfg, mask_ids=None
                      ) -> tuple[torch.Tensor, Params]:
    """Prefill: the cell stepped over time. x [B,S,D]."""
    xn = layers.norm_apply(p["norm"], x, "rmsnorm")
    pre = layers.dense(p["wzifo"], xn)                  # [B,S,4D]
    state = slstm_state_init(x.shape[0], cfg, x.dtype, x.device)
    hs, state = time_scan(lambda rz, x_t, st: _slstm_cell(rz, x_t, st, cfg),
                          p["rzifo"], state, pre)
    hs = hs.to(x.dtype)                                 # [B,S,D]
    hs = layers.norm_apply(p["hnorm"], hs, "rmsnorm")
    if mask_ids is not None and "masks" in p:
        hs = hs * p["masks"][mask_ids][:, None, :]
    return layers.dense(p["wd"], hs), state


def slstm_block_step(p: Params, x: torch.Tensor, state: Params, cfg,
                     mask_ids=None) -> tuple[torch.Tensor, Params]:
    """Decode: x [B,D] -> (y [B,D], new state)."""
    xn = layers.norm_apply(p["norm"], x[:, None, :], "rmsnorm")[:, 0]
    pre = layers.dense(p["wzifo"], xn)
    state = _slstm_cell(p["rzifo"], pre, state, cfg)
    hs = layers.norm_apply(p["hnorm"], state["h"].to(x.dtype), "rmsnorm")
    if mask_ids is not None and "masks" in p:
        hs = hs * p["masks"][mask_ids]
    return layers.dense(p["wd"], hs), state
