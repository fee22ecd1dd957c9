"""Public wrappers of the fused whole-plan kernels (``csrc/fused_plan.cu``).

:func:`pack` flattens a lowered chain's parameters once into the buffers
the kernels read (``core/plan.fused_executor`` packs once per lowering and
serves every chunk from it): fp32 weights and every bias (bf16 biases of an
int8 chain widened, exactly) in one fp32 buffer, int8 weights as stored in
an int8 buffer, and their bf16 scales as stored in a bf16 buffer, so an
int8 weight reaches the kernel as int8 and is dequantized there.
:func:`fused_samples` and
:func:`fused_moments` dispatch by device: a CPU tensor takes the plain
version in ``ref.py``, a CUDA tensor launches the kernel or raises.

The residency guard is this design's own, not the TPU's: a block stages one
row's chain parameters at a time next to three activation tiles, and a spec
whose footprint exceeds the 227 KB of shared memory a Hopper block may opt
into raises :class:`FusedPlanUnsupported` (callers fall back to the per-op
executor).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_plan import ref as _ref
from repro_torch.kernels.fused_plan.ref import FusedPlanUnsupported, FusedSpec

__all__ = ["SMEM_LIMIT", "BLOCK_B_SAMPLES", "BLOCK_B_MOMENTS", "FusedParams",
           "pack", "smem_bytes", "check_residency", "fused_samples",
           "fused_moments", "FusedPlanUnsupported"]

#: Shared memory one Hopper block may opt into (H100/H200: 227 KB).
SMEM_LIMIT = 232_448
#: Voxels per block (multiples of the kernels' 4-voxel thread tile). The
#: moments grid has one block per tile, so its tiles are small enough to
#: give a 4,096-voxel chunk 256 blocks on 132 SMs.
BLOCK_B_SAMPLES = 64
BLOCK_B_MOMENTS = 16

_ACT_CODES = {None: 0, "identity": 0, "relu": 1, "gelu": 2, "gelu_mlp": 2,
              "silu": 3, "sigmoid": 4, "tanh": 5}
_SAMPLES_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_void_p]
_MOMENTS_ARGTYPES = _SAMPLES_ARGTYPES[:7] + [ctypes.c_void_p] \
    + _SAMPLES_ARGTYPES[7:]


@dataclasses.dataclass(frozen=True)
class _Layout:
    desc: np.ndarray                 # int64 chain descriptor (fused_plan.cu)
    shapes: tuple[tuple[int, ...], ...]   # expected shape per param slot
    ld: int                          # activation tile row stride (floats)
    row_floats: int                  # staged parameter floats of one row


@functools.lru_cache(maxsize=64)
def _layout(spec: FusedSpec) -> _Layout:
    """The descriptor the kernels read: header then 15 fields a step (see
    ``Chain``/``Step`` in fused_plan.cu). Offsets are in elements of the
    buffer each tensor lives in (:func:`pack`): an int8 step's weight in
    the int8 buffer and its scale in the bf16 one, everything else in the
    fp32 one."""
    cut = _ref.split_prefix(spec)
    rows, shapes = [], []
    off = soff = qoff = scoff = 0
    width = spec.d_in
    widths = [width]
    for i, st in enumerate(spec.steps):
        act = _ACT_CODES[st.activation]
        if st.kind == "act":
            rows.append([1, act, 0, 0, 0, width, width] + [0] * 8)
            continue
        if st.d_in != width:
            raise ValueError(f"step {i}: d_in {st.d_in} != running width "
                             f"{width}")
        n = spec.n_rows if st.per_sample else 1
        lead = (n,) if st.per_sample else ()
        shapes.append(lead + (st.d_in, st.d_out))
        quant = st.w_dtype == "int8"
        ws_off = 0
        if quant:
            w_off, qoff = qoff, qoff + n * st.d_in * st.d_out
            ws_off, scoff = scoff, scoff + n * st.d_out
            shapes.append(lead + (1, st.d_out))
        else:
            w_off, off = off, off + n * st.d_in * st.d_out
        b_off = bp_off = sw = sb = sbp = 0
        if st.shared_bias:
            b_off, off = off, off + st.d_out
            shapes.append((st.d_out,))
        if st.sample_bias:
            bp_off, off = off, off + spec.n_rows * st.d_out
            shapes.append((spec.n_rows, st.d_out))
        if i >= cut:                     # body: staged in shared memory
            sw, soff = soff, soff + st.d_in * st.d_out
            if st.shared_bias:
                sb, soff = soff, soff + st.d_out
            if st.sample_bias:
                sbp, soff = soff, soff + st.d_out
        rows.append([0, act, int(st.per_sample), int(st.shared_bias),
                     int(st.sample_bias), st.d_in, st.d_out, w_off, b_off,
                     bp_off, sw, sb, sbp, int(quant), ws_off])
        width = st.d_out
        widths.append(width)
    if width != spec.d_out:
        raise ValueError(f"chain ends at width {width}, spec says "
                         f"{spec.d_out}")
    if len(spec.steps) > 32:
        raise FusedPlanUnsupported(f"{len(spec.steps)} steps (> 32 the "
                                   f"kernel's chain descriptor holds)")
    ld = max(widths) | 1       # odd stride: row groups hit other banks
    header = [len(spec.steps), cut, spec.n_rows, spec.n_masks, spec.groups,
              spec.d_in, spec.d_out, ld, soff]
    desc = np.asarray(header + [f for r in rows for f in r], np.int64)
    return _Layout(desc=desc, shapes=tuple(shapes), ld=ld, row_floats=soff)


def smem_bytes(spec: FusedSpec, block_b: int, moments: bool) -> int:
    """Dynamic shared memory of one block: the widest row's staged
    parameters (fp32 — an int8 row is staged dequantized, so this is the
    same at either precision), the prefix/input tile and two ping-pong
    activation tiles (``[block_b, ld]`` each), plus the Welford mean/M2
    tiles in moments mode."""
    lay = _layout(spec)
    floats = lay.row_floats + 3 * block_b * lay.ld
    if moments:
        floats += 2 * block_b * spec.d_out
    return 4 * floats


def check_residency(spec: FusedSpec, block_b: int, moments: bool) -> int:
    """Shared-memory bytes of the launch, or :class:`FusedPlanUnsupported`
    when they exceed :data:`SMEM_LIMIT`."""
    need = smem_bytes(spec, block_b, moments)
    if need > SMEM_LIMIT:
        raise FusedPlanUnsupported(
            f"fused plan needs {need} bytes of shared memory a block "
            f"(> {SMEM_LIMIT}); use the per-op executor")
    return need


@dataclasses.dataclass(frozen=True, eq=False)
class FusedParams:
    """A lowered chain's parameters: the ``param_slots``-ordered tuple (the
    plain versions' operands) and the kernels' operands — ``flat`` (fp32:
    fp32 weights and every bias), and for an int8 chain ``qflat`` (its
    int8 weights) and ``sflat`` (their bf16 scales), both as stored."""
    spec: FusedSpec
    params: tuple[torch.Tensor, ...]
    flat: torch.Tensor
    qflat: torch.Tensor | None = None
    sflat: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        """Bytes of the parameter buffers the kernels read."""
        return sum(t.numel() * t.element_size()
                   for t in (self.flat, self.qflat, self.sflat)
                   if t is not None)


_INT8_DTYPES = {"qparams": torch.int8, "scales": torch.bfloat16}


def pack(spec: FusedSpec, params: tuple[torch.Tensor, ...]) -> FusedParams:
    lay = _layout(spec)
    if len(params) != len(lay.shapes):
        raise ValueError(f"fused spec expects {len(lay.shapes)} params, got "
                         f"{len(params)}")
    parts: dict[str, list[torch.Tensor]] = {"f": [], "q": [], "s": []}
    for (i, slot), p, shape in zip(_ref.param_slots(spec), params,
                                   lay.shapes):
        if tuple(p.shape) != shape:
            raise ValueError(f"step {i} {slot}: shape {tuple(p.shape)}, "
                             f"spec wants {shape}")
        quant = spec.steps[i].w_dtype == "int8"
        buf = {"w": "q" if quant else "f", "ws": "s"}.get(slot, "f")
        want = {"q": torch.int8, "s": torch.bfloat16}.get(buf)
        if want is not None and p.dtype != want:
            raise TypeError(f"step {i} {slot}: {p.dtype}, the int8 chain "
                            f"stores {want}")
        flat_p = p.detach().reshape(-1)
        parts[buf].append(flat_p.float() if buf == "f" else flat_p)
    dev = params[0].device
    flat = (torch.cat(parts["f"]) if parts["f"]
            else torch.empty(0, device=dev))
    if not parts["q"]:
        return FusedParams(spec=spec, params=tuple(params), flat=flat)
    return FusedParams(spec=spec, params=tuple(params), flat=flat,
                       qflat=torch.cat(parts["q"]),
                       sflat=torch.cat(parts["s"]))


def fused_samples(fp: FusedParams, x: torch.Tensor) -> torch.Tensor:
    """x [B, d_in] -> per-row samples [n_rows, B, d_out]."""
    if x.device.type == "cpu":
        return _ref.fused_plan_ref(fp.spec, x, fp.params)
    spec = fp.spec
    dev = _check(fp, x)
    smem = check_residency(spec, BLOCK_B_SAMPLES, moments=False)
    out = torch.empty((spec.n_rows, x.shape[0], spec.d_out),
                      dtype=torch.float32, device=dev)
    fn = _build.bind("fused_plan", "fused_samples_launch", _SAMPLES_ARGTYPES)
    with _build.on_device(dev):
        err = fn(_layout(spec).desc.ctypes.data, x.data_ptr(), x.shape[0],
                 *_param_ptrs(fp), out.data_ptr(), BLOCK_B_SAMPLES, smem,
                 _build.stream_of(dev))
    _build.check_launch("fused_samples", err)
    fused_samples.launches += 1
    fused_samples.int8_launches += int(fp.qflat is not None)
    return out


def fused_moments(fp: FusedParams, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, d_in] -> (mean, std) [B, groups·d_out] over the ``n_masks``
    rows of each group (ddof=0, group-major columns)."""
    if x.device.type == "cpu":
        return _ref.fused_moments_ref(fp.spec, x, fp.params)
    spec = fp.spec
    dev = _check(fp, x)
    smem = check_residency(spec, BLOCK_B_MOMENTS, moments=True)
    shape = (x.shape[0], spec.groups * spec.d_out)
    mean = torch.empty(shape, dtype=torch.float32, device=dev)
    std = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _build.bind("fused_plan", "fused_moments_launch", _MOMENTS_ARGTYPES)
    with _build.on_device(dev):
        err = fn(_layout(spec).desc.ctypes.data, x.data_ptr(), x.shape[0],
                 *_param_ptrs(fp), mean.data_ptr(), std.data_ptr(),
                 BLOCK_B_MOMENTS, smem, _build.stream_of(dev))
    _build.check_launch("fused_moments", err)
    fused_moments.launches += 1
    fused_moments.int8_launches += int(fp.qflat is not None)
    return mean, std


def _check(fp: FusedParams, x: torch.Tensor) -> torch.device:
    spec = fp.spec
    if fp.qflat is None:
        dev = _build.check_operands("fused_plan", x=x, params=fp.flat)
    else:
        dev = _build.check_operands("fused_plan", _INT8_DTYPES, x=x,
                                    params=fp.flat, qparams=fp.qflat,
                                    scales=fp.sflat)
    if x.ndim != 2 or x.shape[1] != spec.d_in or x.shape[0] < 1:
        raise ValueError(f"fused_plan: x {tuple(x.shape)}, spec wants "
                         f"[B >= 1, {spec.d_in}]")
    return dev


def _param_ptrs(fp: FusedParams) -> tuple[int, int, int]:
    """(fp32, int8, bf16-scale) buffer pointers; 0 for an fp32 chain's
    absent int8 buffers, which its descriptor never points into."""
    return tuple(0 if t is None else t.data_ptr()
                 for t in (fp.flat, fp.qflat, fp.sflat))


#: Kernel launches since the count was last set to 0 (``int8_launches``:
#: those with an int8 chain among them).
fused_samples.launches = 0
fused_moments.launches = 0
fused_samples.int8_launches = 0
fused_moments.int8_launches = 0
