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

The residency guard is this design's own, not the TPU's: a block stages a
row's chain parameters in one row slot next to its activation tiles
(:func:`smem_bytes`); a spec whose footprint exceeds the 227 KB of shared
memory a Hopper block may opt into raises :class:`FusedPlanUnsupported`
(callers fall back to the per-op executor).
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

__all__ = ["SMEM_LIMIT", "BLOCK_B_SAMPLES", "BLOCK_B_MOMENTS",
           "FusedParams",
           "pack", "smem_bytes", "check_residency", "moments_block",
           "fused_samples", "fused_moments", "FusedPlanUnsupported"]

#: Shared memory one Hopper block may opt into (H100/H200: 227 KB).
SMEM_LIMIT = 232_448
#: Voxels per block T (a multiple of 4, at most 128; the kernels give each
#: thread ``tile_rm(T)`` voxels: 2 below 64, 4 below 128, else 8). The
#: moments grid is (tile, group): at T = 64 a 4,096-voxel chunk of the
#: 4-group IVIM plan is 256 blocks on 132 SMs.
BLOCK_B_SAMPLES = 64
BLOCK_B_MOMENTS = 64
#: The kernels' block size, the tiles' padding (ldt = T + _PAD floats), and
#: the Welford elements a thread holds in registers (T·d_out ≤ 4·256).
_THREADS = 256
_PAD = 8
_BAR_FLOATS = 8
_WELFORD_PER_THREAD = 4

_ACT_CODES = {None: 0, "identity": 0, "relu": 1, "gelu": 2, "gelu_mlp": 2,
              "silu": 3, "sigmoid": 4, "tanh": 5}
_SAMPLES_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_void_p]
_MOMENTS_ARGTYPES = _SAMPLES_ARGTYPES[:7] + [ctypes.c_void_p] \
    + _SAMPLES_ARGTYPES[7:]


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def _r8(n: int) -> int:
    return (n + 7) // 8 * 8


@dataclasses.dataclass(frozen=True)
class _Layout:
    desc: np.ndarray                 # int64 chain descriptor (fused_plan.cu)
    shapes: tuple[tuple[int, ...], ...]   # expected shape per param slot
    pfx_rows: int                    # features of the input/prefix tile
    buf_rows: int                    # features of each ping-pong tile
    slot_floats: int                 # one staged row slot (floats)
    deq_floats: int                  # the int8 weights' dequant buffer


@functools.lru_cache(maxsize=64)
def _layout(spec: FusedSpec) -> _Layout:
    """The descriptor the kernels read: 11 header fields then 16 a step (see
    ``Chain``/``Step`` in fused_plan.cu). Offsets into the parameter
    buffers are in elements of the buffer each tensor lives in
    (:func:`pack`): an int8 step's weight in the int8 buffer and its scale
    in the bf16 one, everything else in the fp32 one.

    A body step's staged copy lives in a row slot: an fp32 weight as
    ``[round8(d_in)][d_out]`` floats (as stored, one bulk copy; zero rows
    past ``d_in`` for the tensor cores' 8-deep k-steps), biases as
    ``round4(d_out)`` floats,
    int8 weights as stored after all the floats (bytes, 16-aligned); an
    int8 weight is widened into the dequant buffer, laid out as an fp32
    one. Every staged tensor starts 16-byte aligned. Activation tiles have
    ``round8`` rows of every width they hold."""
    cut = _ref.split_prefix(spec)
    rows, shapes, quant_rows = [], [], []
    off = soff = qoff = scoff = doff = 0
    width = spec.d_in
    widths = [width]
    for i, st in enumerate(spec.steps):
        act = _ACT_CODES[st.activation]
        if st.kind == "act":
            rows.append([1, act, 0, 0, 0, width, width] + [0] * 9)
            widths.append(width)
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
            w_floats = _r4(_r8(st.d_in) * st.d_out)
            if quant:
                sw, doff = doff, doff + w_floats
                quant_rows.append((len(rows), st.d_in * st.d_out))
            else:
                sw, soff = soff, soff + w_floats
            if st.shared_bias:
                sb, soff = soff, soff + _r4(st.d_out)
            if st.sample_bias:
                sbp, soff = soff, soff + _r4(st.d_out)
        rows.append([0, act, int(st.per_sample), int(st.shared_bias),
                     int(st.sample_bias), st.d_in, st.d_out, w_off, b_off,
                     bp_off, sw, sb, sbp, 0, int(quant), ws_off])
        width = st.d_out
        widths.append(width)
    if width != spec.d_out:
        raise ValueError(f"chain ends at width {width}, spec says "
                         f"{spec.d_out}")
    if len(spec.steps) > 32:
        raise FusedPlanUnsupported(f"{len(spec.steps)} steps (> 32 the "
                                   f"kernel's chain descriptor holds)")
    sq = 4 * soff                        # int8 weights after the floats
    for r, nbytes in quant_rows:
        rows[r][13], sq = sq, sq + (nbytes + 15) // 16 * 16
    pfx_rows = _r8(max(spec.d_in, widths[cut]))
    buf_rows = _r8(max(widths[1:]))
    header = [len(spec.steps), cut, spec.n_rows, spec.n_masks, spec.groups,
              spec.d_in, spec.d_out, pfx_rows, buf_rows, sq // 4, doff]
    desc = np.asarray(header + [f for r in rows for f in r], np.int64)
    return _Layout(desc=desc, shapes=tuple(shapes), pfx_rows=pfx_rows,
                   buf_rows=buf_rows, slot_floats=sq // 4, deq_floats=doff)


def smem_bytes(spec: FusedSpec, block_b: int) -> int:
    """Dynamic shared memory of one block: 32 bytes of mbarriers, the row
    slot, the dequant buffer (int8 chains), the input/prefix tile and two
    ping-pong activation tiles (``[round8(rows)][block_b + 8]`` floats
    each). The Welford state of moments mode lives in registers."""
    lay = _layout(spec)
    ldt = block_b + _PAD
    floats = (_BAR_FLOATS + lay.slot_floats + lay.deq_floats
              + (lay.pfx_rows + 2 * lay.buf_rows) * ldt)
    return 4 * floats


def check_residency(spec: FusedSpec, block_b: int) -> int:
    """The launch's shared-memory bytes (:func:`smem_bytes`); raises
    :class:`FusedPlanUnsupported` past :data:`SMEM_LIMIT`."""
    need = smem_bytes(spec, block_b)
    if need > SMEM_LIMIT:
        raise FusedPlanUnsupported(
            f"fused plan needs {need} bytes of shared memory a block "
            f"(> {SMEM_LIMIT}); use the per-op executor")
    return need


def moments_block(spec: FusedSpec) -> int:
    """Voxels a moments block: :data:`BLOCK_B_MOMENTS`, or fewer where the
    tile's outputs would exceed the Welford registers (``T·d_out`` at most
    4 a thread); :class:`FusedPlanUnsupported` past ``d_out`` = 256."""
    fit = _WELFORD_PER_THREAD * _THREADS // spec.d_out // 4 * 4
    if fit < 4:
        raise FusedPlanUnsupported(
            f"d_out {spec.d_out}: the moments kernel holds at most "
            f"{_WELFORD_PER_THREAD * _THREADS // 4} outputs a voxel")
    return min(BLOCK_B_MOMENTS, fit)


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
    _no_grad("fused_samples", fp, x)
    if x.device.type == "cpu":
        return _ref.fused_plan_ref(fp.spec, x, fp.params)
    spec = fp.spec
    dev = _check(fp, x)
    smem = check_residency(spec, BLOCK_B_SAMPLES)
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
    _no_grad("fused_moments", fp, x)
    if x.device.type == "cpu":
        return _ref.fused_moments_ref(fp.spec, x, fp.params)
    spec = fp.spec
    dev = _check(fp, x)
    block_b = moments_block(spec)
    smem = check_residency(spec, block_b)
    shape = (x.shape[0], spec.groups * spec.d_out)
    mean = torch.empty(shape, dtype=torch.float32, device=dev)
    std = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _build.bind("fused_plan", "fused_moments_launch", _MOMENTS_ARGTYPES)
    with _build.on_device(dev):
        err = fn(_layout(spec).desc.ctypes.data, x.data_ptr(), x.shape[0],
                 *_param_ptrs(fp), mean.data_ptr(), std.data_ptr(),
                 block_b, smem, _build.stream_of(dev))
    _build.check_launch("fused_moments", err)
    fused_moments.launches += 1
    fused_moments.int8_launches += int(fp.qflat is not None)
    return mean, std


def _no_grad(kernel: str, fp: FusedParams, x: torch.Tensor) -> None:
    if not torch.is_grad_enabled():
        return
    _build.check_no_grad(kernel, x=x, params=fp.flat, qparams=fp.qflat,
                         scales=fp.sflat,
                         **{f"params[{i}]": t
                            for i, t in enumerate(fp.params)})


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
