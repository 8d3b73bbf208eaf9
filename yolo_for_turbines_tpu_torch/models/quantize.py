"""Post-training int8 quantization of the folded inference path, in PyTorch.

Counterpart of ``yolo_for_turbines_tpu/models/quantize.py``, with the same
recipe and the same quantized tree:

- weights: symmetric per-output-channel int8 (``_wq``, the JAX package's
  numpy code, so codes and scales are bit-identical);
- activations: symmetric per-tensor int8, scales calibrated in f32 over a
  representative batch (``calibrate``);
- compute: s8 x s8 -> i32 products, exact like XLA's int32 convs (on CUDA
  an implicit GEMM, kernel K7, ``ops/kernels/int8_conv_kernel.py``; else
  im2col + ``torch._int_mm``), then an f32 epilogue of dequant, bias,
  activation, residual add and requant in the JAX operation order (on CUDA
  in one pass, kernel K6, ``ops/kernels/int8_epilogue_kernel.py``);
- heads run in ``compute_dtype`` from the dequantized trunk;
- a concat feeding a conv runs as two int8 convs on the split weights,
  dequant-summed with per-branch scales: an upsample concat followed by a
  conv ("conv" mode) and every CSP stage's ``fuse``; an upsample concat
  feeding a head concats the dequantized branches ("head" mode); one
  feeding anything else is requantized to one calibrated scale
  ("requant" mode, which no built-in family reaches);
- a max pool runs on the s8 codes (it keeps their scale), and a route
  saves the codes with their scale.

On CUDA the 26x26x512 residual stage runs the fused int8 kernel K4
(``ops/kernels/resblock_int8_kernel.py``), routed on each call's own shape;
CSP blocks take the layer path, as in the JAX package.
The quantized tree is
``{"layers": [...], "scales": (n,) f32}`` as in JAX (``models/convert.py::
qparams_from_numpy`` reads the JAX package's); ``pack_int8`` turns it once
into the per-layer operands ``apply_inference_int8`` consumes, so a serving
call does no packing and no host sync.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.int8_conv_kernel import apply_int8_conv, int8_conv_reference, kmajor
from ..ops.kernels.int8_epilogue_kernel import int8_epilogue, int8_epilogue_reference
from ..ops.kernels.resblock_int8_kernel import (
    KERNEL_C,
    apply_residual_stage_int8_fused,
    kmajor_weights,
    pack_int8_stage,
)
from ..utils.profiling import span
from .blocks import full_f32, get_activation, maxpool2d
from .convert import qparams_from_numpy
from .cspdarknet import SINGLE_CONVS, PlanCSP
from .yolov3 import (
    PlanConv,
    PlanHead,
    PlanMaxPool,
    PlanResidual,
    PlanRoute,
    PlanUpsample,
    _head_reshape,
)

INPUT_SCALE = 1.0 / 127.0  # inputs are [0, 1]


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def _wq(w) -> tuple:
    """Per-output-channel symmetric int8 weight quant: (wq, s_w[oc])."""
    w = _np32(w)
    s = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s = np.maximum(s, 1e-12)
    wq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return torch.from_numpy(wq), torch.from_numpy(s.astype(np.float32))


def calibrate(plan, folded, x_calib, activation: str = "leaky_relu"):
    """Record each int8 tensor's max-abs over a representative batch, in the
    order ``apply_inference_int8`` consumes them, in true f32 (TF32 off) on
    ``x_calib``'s device; one host transfer at the end. ``folded`` is a
    folded tree in the JAX layout (HWIO). Returns a tuple of per-tensor
    scales (max/127)."""
    act = get_activation(activation)
    x = torch.as_tensor(x_calib)
    dev = x.device

    def conv(p, t, kernel, stride):
        w = torch.tensor(_np32(p["w"]), device=dev).permute(3, 2, 0, 1)
        b = torch.tensor(_np32(p["b"]), device=dev)
        pad = 1 if kernel == 3 else 0
        return act(F.conv2d(t, w, stride=stride, padding=pad) + b[:, None, None])

    maxes: List[torch.Tensor] = []

    def rec(t):
        maxes.append(t.abs().amax())
        return t

    plan_t = tuple(plan)
    routes = []
    with torch.inference_mode(), full_f32():
        x = x.float().permute(0, 3, 1, 2)  # NCHW inside
        for i, (entry, p) in enumerate(zip(plan_t, folded)):
            if isinstance(entry, PlanConv):
                x = rec(conv(p["conv"], x, entry.kernel, entry.stride))
            elif isinstance(entry, PlanResidual):
                for bp in p["blocks"]:
                    y = rec(conv(bp["conv1"], x, 1, 1))
                    y = conv(bp["conv2"], y, 3, 1)
                    x = rec(x + y if entry.use_residual else y)
                if entry.save_route:
                    routes.append(x)
            elif isinstance(entry, PlanCSP):
                # apply_inference_int8's order: split1, split2, per block
                # (conv1, the sum), transition, fuse (which reads the concat
                # as two branches: the merged tensor gets no scale)
                shortcut = rec(conv(p["split1"], x, 1, 1))
                y = rec(conv(p["split2"], x, 1, 1))
                for bp in p["blocks"]:
                    h = rec(conv(bp["conv1"], y, 1, 1))
                    y = rec(y + conv(bp["conv2"], h, 3, 1))
                y = rec(conv(p["transition"], y, 1, 1))
                x = rec(conv(p["fuse"], torch.cat([y, shortcut], dim=1), 1, 1))
                if entry.save_route:
                    routes.append(x)
            elif isinstance(entry, PlanHead):
                pass  # heads run in compute_dtype; no int8 tensors
            elif isinstance(entry, PlanMaxPool):
                x = maxpool2d(x, entry.kernel, entry.stride)  # keeps the scale
            elif isinstance(entry, PlanRoute):
                routes.append(x)
            elif isinstance(entry, PlanUpsample):
                up = F.interpolate(x, scale_factor=2, mode="nearest")
                x = torch.cat([up, routes.pop()], dim=1)
                # only a "requant" concat is quantized as one tensor
                if _concat_mode(plan_t[i + 1] if i + 1 < len(plan_t) else None) == "requant":
                    rec(x)
            else:
                raise TypeError(f"unknown plan entry {entry!r}")
        m = torch.stack(maxes).cpu().numpy()
    return tuple(float(max(v, 1e-12)) / 127.0 for v in m)


def _concat_mode(next_entry) -> str:
    """How a channel concat's consumer handles two differently-scaled int8
    branches: "conv" (split-weight int8 convs, dequant-summed), "head"
    (the head concats the dequantized branches), "requant" (the concat
    requantized to one calibrated scale)."""
    if isinstance(next_entry, PlanConv):
        return "conv"
    if isinstance(next_entry, PlanHead):
        return "head"
    return "requant"


def _q_conv(p) -> dict:
    wq, sw = _wq(p["w"])
    return {"wq": wq, "sw": sw, "b": _np32(p["b"])}


def _q_blocks(blocks) -> list:
    out = []
    for bp in blocks:
        w1q, s1 = _wq(bp["conv1"]["w"])
        w2q, s2 = _wq(bp["conv2"]["w"])
        out.append({
            "w1q": w1q, "s1": s1, "b1": _np32(bp["conv1"]["b"]),
            "w2q": w2q, "s2": s2, "b2": _np32(bp["conv2"]["b"]),
        })
    return out


def quantize_folded(plan, folded, x_calib, activation: str = "leaky_relu"):
    """Quantize a folded tree (JAX layout) given a calibration batch.

    Returns {"layers": [...], "scales": (n,) f32} on ``x_calib``'s device:
    per-entry int8 weights and f32 epilogue constants, heads and weightless
    entries in full precision, and the calibrated activation scales."""
    scales = calibrate(plan, folded, x_calib, activation)
    layers = []
    for entry, p in zip(plan, folded):
        if isinstance(entry, PlanConv):
            layers.append(_q_conv(p["conv"]))
        elif isinstance(entry, PlanResidual):
            layers.append({"blocks": _q_blocks(p["blocks"])})
        elif isinstance(entry, PlanCSP):
            stage = {k: _q_conv(p[k]) for k in SINGLE_CONVS}
            stage["blocks"] = _q_blocks(p["blocks"])
            layers.append(stage)
        elif isinstance(entry, (PlanHead, PlanUpsample, PlanMaxPool, PlanRoute)):
            layers.append(p)
        else:
            raise TypeError(f"unknown plan entry {entry!r}")
    tree = {"layers": layers, "scales": np.asarray(scales, np.float32)}
    return qparams_from_numpy(plan, tree, torch.as_tensor(x_calib).device)


def _wmat(wq) -> torch.Tensor:
    """HWIO s8 weight -> the (kh*kw*Cin, Cout) matrix ``_conv_i8`` takes,
    rows zero-padded to a multiple of 8 (``torch._int_mm`` on CUDA wants
    K % 8 == 0; the stem has 3*3*3 = 27). A contiguous weight that needs no
    padding comes back as a view, sharing its storage."""
    kh, kw, ci, co = wq.shape
    m = wq.reshape(kh * kw * ci, co)
    pad = -m.shape[0] % 8
    return F.pad(m, (0, 0, 0, pad)) if pad else m.contiguous()


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _conv_i8(xq, wmat, kernel: int, stride: int, pad: int, rows=None, wk=None,
             portable: bool = False):
    """NHWC s8 x ``_wmat`` s8 -> NHWC i32, exact like XLA's int32 conv,
    inside the span ``int8.conv``. On the card K7 with ``wk``, the K-major
    copy of ``wmat`` (``int8_conv_kernel.apply_int8_conv``, which launches
    it or raises); on the CPU and when ``portable``, the plain version:
    im2col in (kh, kw, Cin) order, then ``int_mm``. A row shard (``rows``,
    ``parallel/spatial.py::Rows``) takes the plain version with its halo
    rows of codes from its neighbours in place of the row padding (code 0
    at the image's edges, as the padding)."""
    with span("int8.conv"):
        if rows is not None and rows.sharded:
            if pad:
                from ..parallel.spatial import halo

                xq = _nhwc(halo(_nchw(xq), pad, pad if stride == 1 else 0, 0,
                                rows.layout.space_group))
                xq = F.pad(xq, (0, 0, pad, pad))
                pad = 0
        elif xq.is_cuda and not portable:
            return apply_int8_conv(xq, wmat, wk, kernel, stride, pad)
        return int8_conv_reference(xq, wmat, kernel, stride, pad)


def _requant(y_f, s_out):
    return torch.round(y_f / s_out).clamp_(-127, 127).to(torch.int8)


def _epilogue(y32, d, b, s_out, activation, residual=None, extra=None,
              portable: bool = False):
    """Dequant + bias + activation (+ residual add) + requant of an int8
    conv's i32 output, in f32 in the JAX operation order, inside the span
    ``int8.epilogue``; ``extra`` = (y32b, db) adds a second partial conv,
    ``residual`` = (rq, rs) the block input. K6 on CUDA; the plain
    composition on the CPU and when ``portable``, with the same codes."""
    with span("int8.epilogue"):
        if portable:
            return int8_epilogue_reference(y32, d, b, s_out, activation, residual, extra)
        # K6 reads whole rows: where C % 8 != 0, int_mm's output is a view
        extra = None if extra is None else (extra[0].contiguous(), extra[1])
        return int8_epilogue(y32.contiguous(), d, b, s_out, activation, residual, extra)


def residual_blocks_int8(xq, blocks, activation: str = "leaky_relu", rows=None,
                         portable: bool = False):
    """A quantized residual stage layer by layer (the path of every stage
    the fused kernel is not routed to): per block an int8 1x1 and 3x3 conv,
    each with its f32 epilogue. ``blocks`` from :func:`pack_int8_blocks`."""
    for bq in blocks:
        t1 = _epilogue(_conv_i8(xq, bq["w1"], 1, 1, 0, wk=bq["w1k"], portable=portable),
                       bq["d1"], bq["b1"], bq["s1"], activation, portable=portable)
        res = (xq, bq["rs"]) if bq["rs"] is not None else None
        xq = _epilogue(_conv_i8(t1, bq["w2"], 3, 1, 1, rows, bq["w2k"], portable), bq["d2"],
                       bq["b2"], bq["s2"], activation, residual=res, portable=portable)
    return xq


def _upsample2x(xq):
    b, h, w, c = xq.shape
    return xq[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _head_weights(p, compute_dtype):
    def oihw(a):
        return a.permute(3, 2, 0, 1).to(compute_dtype).contiguous(
            memory_format=torch.channels_last)

    return {"w1": oihw(p["conv1"]["w"]), "b1": p["conv1"]["b"].to(compute_dtype),
            "w2": oihw(p["conv2"]["w"]), "b2": p["conv2"]["b"].to(compute_dtype)}


def _kmajor(wmat, cin: int, kernel: int, portable: bool):
    """K7's K-major copy of a layer-path weight; None in a ``portable``
    pack, whose forward runs no kernel (the exported program traces the
    packing, so a copy there would run in every call)."""
    return None if portable else kmajor(wmat, cin, kernel)


def pack_int8_blocks(blocks_q, s_in, s1_list, s2_list, use_residual: bool,
                     portable: bool = False) -> list:
    """Per-block operands of the layer-by-layer path
    (:func:`residual_blocks_int8`): ``_wmat`` weights and their K-major
    copies, which K7 reads (``_kmajor``), ``d = s_in * s_w`` rows, and each
    block's mid/out/residual scales. ``blocks_q`` is in the ``_q_blocks`` layout;
    the scales are f32 0-dim tensors."""
    out, s_x = [], s_in
    for bp, s1_out, s2_out in zip(blocks_q, s1_list, s2_list):
        w1, w2 = _wmat(bp["w1q"]), _wmat(bp["w2q"])
        out.append({
            "w1": w1, "d1": s_x * bp["s1"], "b1": bp["b1"], "s1": s1_out,
            "w2": w2, "d2": s1_out * bp["s2"], "b2": bp["b2"], "s2": s2_out,
            "rs": s_x if use_residual else None,
            "w1k": _kmajor(w1, bp["w1q"].shape[2], 1, portable),
            "w2k": _kmajor(w2, bp["w2q"].shape[2], 3, portable),
        })
        s_x = s2_out
    return out


def _pack_conv(p, kernel: int, stride: int, s_in, s_out, split=None,
               portable: bool = False) -> dict:
    """A quantized conv's layer-path operands: ``_wmat`` weights (views of
    ``p["wq"]`` where no padding is needed) and their K-major copies, which
    K7 reads (``_kmajor``), under the same key with a ``k`` after it, ``d =
    s_in * s_w`` rows, bias and output scale. ``split = (Ca, s_a, s_b)`` splits the
    weights at input channel Ca for two int8 convs on the branches of a
    concat, with rows ``da = s_a * s_w`` and ``db = s_b * s_w``."""
    q = {"kernel": kernel, "stride": stride, "pad": 1 if kernel == 3 else 0, "b": p["b"],
         "s_out": s_out}
    if split is None:
        q["w"], q["d"] = _wmat(p["wq"]), s_in * p["sw"]
        q["wk"] = _kmajor(q["w"], p["wq"].shape[2], kernel, portable)
    else:
        ca, s_a, s_b = split
        q["wa"], q["wb"] = _wmat(p["wq"][:, :, :ca]), _wmat(p["wq"][:, :, ca:])
        q["da"], q["db"] = s_a * p["sw"], s_b * p["sw"]
        q["wak"] = _kmajor(q["wa"], ca, kernel, portable)
        q["wbk"] = _kmajor(q["wb"], p["wq"].shape[2] - ca, kernel, portable)
    return q


def _run_conv(q, xq, activation: str, xb=None, rows=None, portable: bool = False):
    """The conv of :func:`_pack_conv` on s8 codes: one int8 conv and its
    epilogue, or with ``xb`` (the second branch of a split conv) two int8
    convs dequant-summed in one epilogue."""
    geom = q["kernel"], q["stride"], q["pad"], rows
    if xb is None:
        return _epilogue(_conv_i8(xq, q["w"], *geom, q["wk"], portable), q["d"], q["b"],
                         q["s_out"], activation, portable=portable)
    return _epilogue(_conv_i8(xq, q["wa"], *geom, q["wak"], portable), q["da"], q["b"],
                     q["s_out"], activation,
                     extra=(_conv_i8(xb, q["wb"], *geom, q["wbk"], portable), q["db"]),
                     portable=portable)


def pack_int8(plan, qparams, compute_dtype=torch.bfloat16, kernel_operands: bool = True,
              portable: bool = False) -> list:
    """Walk the plan once over ``qparams`` and fold the calibrated scale
    chain into per-entry operands: ``d = s_in * s_w`` rows and 0-dim scale
    tensors for the layer path (weights as views of ``qparams``' where no
    padding is needed), K4's stacked operands and its K-major weight copies
    for every ``use_residual`` stage whose channel count the kernel takes
    (C = 512: one stage of Darknet-53; None elsewhere, CSP blocks
    included, and everywhere with ``kernel_operands=False`` or
    ``portable``), the K-major copy of every layer-path weight, which K7
    reads (None when ``portable``: the pack of the portable forward, which
    runs no kernel), head weights in ``compute_dtype``. Nothing here depends on the image size: each
    call of ``apply_inference_int8`` routes such a
    stage to K4 or to the layer path on its own shape, as the JAX function
    does. The scales are drawn in the JAX function's order and its f32
    arithmetic is kept; everything stays on the qparams' device."""
    scales = qparams["scales"]
    si = iter(range(scales.shape[0]))

    def scale():
        return scales[next(si)]

    s_x = torch.tensor(INPUT_SCALE, dtype=torch.float32, device=scales.device)
    packed = [{"s_in": s_x}]
    routes = []  # scales of the saved routes
    pending = None  # (s_a, s_b) of an upsample concat, (channels of a)
    plan_t = tuple(plan)
    for i, (entry, p) in enumerate(zip(plan_t, qparams["layers"])):
        nxt = plan_t[i + 1] if i + 1 < len(plan_t) else None
        if isinstance(entry, PlanConv):
            s_out = scale()
            if pending is not None:
                (s_a, s_b), ca = pending
                pending = None
                q = _pack_conv(p, entry.kernel, entry.stride, None, s_out, split=(ca, s_a, s_b),
                               portable=portable)
            else:
                q = _pack_conv(p, entry.kernel, entry.stride, s_x, s_out, portable=portable)
            s_x = s_out
        elif isinstance(entry, PlanResidual):
            # the stream interleaves (s1, s2) per block
            pairs = [(scale(), scale()) for _ in p["blocks"]]
            s1_list, s2_list = [a for a, _ in pairs], [b for _, b in pairs]
            fusable = (kernel_operands and not portable and entry.use_residual
                       and entry.channels == KERNEL_C)
            stage = pack_int8_stage(p["blocks"], s_x, s1_list, s2_list) if fusable else None
            q = {"blocks": pack_int8_blocks(p["blocks"], s_x, s1_list, s2_list,
                                            entry.use_residual, portable),
                 "stage": stage,
                 # the K-major weights K4 reads, made here once per model
                 "stage_kmajor": kmajor_weights(stage[0], stage[4]) if fusable else None}
            s_x = s2_list[-1]
            if entry.save_route:
                routes.append(s_x)
        elif isinstance(entry, PlanCSP):
            # the JAX stream: split1, split2, (s1, s2) per block,
            # transition, fuse
            s_sc = scale()
            q = {"split1": _pack_conv(p["split1"], 1, 1, s_x, s_sc, portable=portable)}
            s_y = scale()
            q["split2"] = _pack_conv(p["split2"], 1, 1, s_x, s_y, portable=portable)
            pairs = [(scale(), scale()) for _ in p["blocks"]]
            q["blocks"] = pack_int8_blocks(p["blocks"], s_y, [a for a, _ in pairs],
                                           [b for _, b in pairs], True, portable)
            s_y = pairs[-1][1] if pairs else s_y
            s_t = scale()
            q["transition"] = _pack_conv(p["transition"], 1, 1, s_y, s_t, portable=portable)
            s_x = scale()
            # fuse reads [transition output, shortcut] as two branches
            q["fuse"] = _pack_conv(p["fuse"], 1, 1, None, s_x,
                                   split=(entry.branch_ch, s_t, s_sc), portable=portable)
            if entry.save_route:
                routes.append(s_x)
        elif isinstance(entry, PlanHead):
            q = _head_weights(p, compute_dtype)
            if pending is not None:
                (q["s_a"], q["s_b"]), _ = pending
                pending = None
            else:
                q["s"] = s_x
        elif isinstance(entry, PlanUpsample):
            if _concat_mode(nxt) == "requant":
                q = {"s_a": s_x, "s_b": routes.pop(), "s_out": scale()}
                s_x = q["s_out"]
            else:
                pending = ((s_x, routes.pop()), entry.in_ch)
                q = {}
        elif isinstance(entry, PlanRoute):
            routes.append(s_x)
            q = {}
        elif isinstance(entry, PlanMaxPool):
            q = {}  # the codes keep their scale
        else:
            raise TypeError(f"unknown plan entry {entry!r}")
        packed.append(q)
    return packed


def apply_inference_int8(
    plan,
    qparams,
    x,
    activation: str = "leaky_relu",
    raw_heads: bool = False,
    compute_dtype=torch.bfloat16,
    portable: bool = False,
    packed: Optional[list] = None,
    head_inputs: Optional[list] = None,
    layout=None,
):
    """int8 twin of the folded forward over ``quantize_folded`` output.

    x: (B, S, S, 3) float in [0, 1] on the qparams' device. Returns one head
    per scale, coarsest first: raw NHWC heads in ``compute_dtype`` with
    ``raw_heads``, else (B, A, S, S, 5+C) f32. ``portable=True`` skips the
    fused-stage router, which otherwise decides on this call's shapes, and
    runs no kernel (each conv's epilogue the plain composition, not K6):
    the hermetic serve module (``serving.py``) is traced through it.
    ``packed`` is ``pack_int8(plan, qparams, compute_dtype)``, made here
    when not given (with no kernel's operands when portable).
    ``head_inputs``, when a list, receives per head the s8 trunk tensors it
    reads (two for a concat head), so a caller can check what the int8
    trunk decided. ``layout`` (``parallel/spatial.py::Layout``) runs the
    forward on the rank's rows of a spatial mesh, laid out by its policy,
    the s8 codes' halos exchanged before each 3x3 conv and the SAME pool,
    the heads gathered; it takes the layer path (``portable`` is implied)."""
    act = get_activation(activation)
    if layout is not None:
        portable = True
    if packed is None:
        packed = pack_int8(plan, qparams, compute_dtype, portable=portable)

    def relay(fn, t, rows, *args):
        """A layout step of ``layout`` on an NHWC tensor."""
        t, rows = fn(_nchw(t), rows, *args)
        return _nhwc(t), rows

    with torch.inference_mode():
        xq = _requant(torch.as_tensor(x).float(), packed[0]["s_in"])
        rows = None
        if layout is not None:
            xq, rows = relay(lambda t, _: layout.enter(t), xq, None)
        preds, routes = [], []
        pending = None  # (upsampled trunk, route) of an upsample concat
        for entry, q in zip(plan, packed[1:]):
            if isinstance(entry, PlanConv):
                if pending is not None:
                    xq = _run_conv(q, pending[0], activation, xb=pending[1], rows=rows,
                                   portable=portable)
                    pending = None
                else:
                    if rows is not None:
                        xq, rows = relay(layout.fit, xq, rows, entry.stride)
                    xq = _run_conv(q, xq, activation, rows=rows, portable=portable)
                if rows is not None:
                    xq, rows = relay(layout.constrain, xq, rows)
            elif isinstance(entry, PlanResidual):
                fused = None
                if q["stage"] is not None and not portable:
                    fused = apply_residual_stage_int8_fused(q["stage"], xq, activation,
                                                            kmajor=q["stage_kmajor"])
                xq = fused if fused is not None else residual_blocks_int8(
                    xq, q["blocks"], activation, rows, portable)
                if entry.save_route:
                    routes.append(xq)
            elif isinstance(entry, PlanCSP):
                shortcut = _run_conv(q["split1"], xq, activation, portable=portable)
                yq = residual_blocks_int8(
                    _run_conv(q["split2"], xq, activation, portable=portable), q["blocks"],
                    activation, rows, portable)
                yq = _run_conv(q["transition"], yq, activation, portable=portable)
                xq = _run_conv(q["fuse"], yq, activation, xb=shortcut, portable=portable)
                if entry.save_route:
                    routes.append(xq)
            elif isinstance(entry, PlanHead):
                trunk = pending if pending is not None else (xq,)
                pending = None
                if head_inputs is not None:
                    head_inputs.append(trunk)
                parts = [(t.float() * s).to(compute_dtype) for t, s in zip(
                    trunk, (q["s_a"], q["s_b"]) if len(trunk) == 2 else (q["s"],))]
                xf = _nchw(parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1))
                if rows is None:
                    y = F.conv2d(xf, q["w1"], padding=1)
                else:
                    y = rows.conv(xf, q["w1"], None, 1, 1)
                y = act(y + q["b1"][:, None, None])
                y = F.conv2d(y, q["w2"]) + q["b2"][:, None, None]
                if rows is not None:
                    y = layout.gather(y, rows)
                y = _nhwc(y)
                preds.append(y if raw_heads else _head_reshape(
                    y, entry.num_classes, entry.anchors_per_scale))
            elif isinstance(entry, PlanUpsample):
                up, route = _upsample2x(xq), routes.pop()
                if rows is not None:
                    # the route was laid out at this height by the same rule
                    up, rows = relay(layout.constrain, up, rows)
                if "s_out" in q:  # "requant": one tensor at one scale
                    xq = _requant(torch.cat([up.float() * q["s_a"], route.float() * q["s_b"]],
                                            dim=-1), q["s_out"])
                else:
                    pending = (up, route)
            elif isinstance(entry, PlanRoute):
                routes.append(xq)
            elif isinstance(entry, PlanMaxPool):
                # NHWC codes through the NCHW pool and back
                if rows is None:
                    xq = _nhwc(maxpool2d(_nchw(xq), entry.kernel, entry.stride)).contiguous()
                else:
                    xq, rows = relay(layout.fit, xq, rows, entry.stride)
                    xq = _nhwc(rows.pool(_nchw(xq), entry.kernel, entry.stride)).contiguous()
                    xq, rows = relay(layout.constrain, xq, rows)
            else:
                raise TypeError(f"unknown plan entry {entry!r}")
    return preds
