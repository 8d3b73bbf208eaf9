"""Building blocks of the trainable and the folded model, in PyTorch.

Counterpart of ``yolo_for_turbines_tpu/models/blocks.py``. Inside the model
activations are NCHW tensors (stored channels_last on the card, so their
memory is NHWC) and conv weights are OIHW; the JAX package keeps NHWC / HWIO.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import maxpool_kernel
from ..ops.kernels.epilogue_kernel import conv_epilogue
from ..utils import profiling

BN_EPS = 1e-5  # torch BatchNorm2d default, needed for darknet-weight parity
BN_MOMENTUM = 0.1  # torch default: new = (1 - m) * old + m * batch


def leaky_relu(x):
    return F.leaky_relu(x, 0.1)


def mish(x):
    return F.mish(x)


def silu(x):
    return F.silu(x)


def relu(x):
    return F.relu(x)


ACTIVATIONS = {"leaky_relu": leaky_relu, "mish": mish, "silu": silu, "relu": relu}
# the activation name kernel K5 (``conv_epilogue``) takes for each function
# a folded conv may be given; None is a head's last 1x1
EPILOGUE_ACTIVATIONS = {None: "identity", leaky_relu: "leaky_relu", mish: "mish",
                        silu: "silu", relu: "relu"}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {name}")
    return ACTIVATIONS[name]


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convs and cuBLAS matmuls, restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def conv2d(x, w, stride: int, padding: int, bias=None):
    """NCHW conv with explicit symmetric padding and floor output sizes.

    ``padding=1`` on a stride-2 3x3 conv pads both sides like the JAX
    package's explicit ((1, 1), (1, 1)); torch's ``"same"`` would not."""
    return F.conv2d(x, w, bias, stride=stride, padding=padding)


class ConvBlock(nn.Module):
    """Conv (no bias) -> BN -> activation, or conv + bias with no BN (a
    head's last 1x1): the trainable layer of ``init_conv`` and
    ``apply_conv_block``.

    ``conv.weight`` is the JAX ``w`` in OIHW; ``bn.weight`` / ``bn.bias`` are
    ``scale`` / ``bias``, ``bn.running_mean`` / ``bn.running_var`` the batch
    stats ``mean`` / ``var``. Init as ``init_conv``: weights (and a BN-less
    conv's bias) U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from ``generator``;
    scale 1, bias 0, mean 0, var 1.

    ``nn.BatchNorm2d`` keeps the rules of ``bn_scale_shift``: eps 1e-5 and
    momentum 0.1; eval mode normalizes with the running statistics; train
    mode normalizes with the batch mean and biased variance over (B, H, W)
    and updates the running variance with the unbiased one (n / (n - 1)).
    Where it differs from ``bn_batch_moments``: the JAX package takes the
    moments in one pass shifted by the running mean, E[(x - m)^2] -
    (E[x] - m)^2 clamped at 0, and applies ``y * inv + shift`` with the
    coefficients rounded to the compute dtype; torch's kernels reduce in
    their own order and compute ``(y - mean) * invstd * w + b``. The values
    agree to f32 rounding, not bit for bit. torch refuses train mode with
    one value per channel, where the JAX package divides by max(n - 1, 1).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bn: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        # symmetric padding with floor sizes, as the JAX conv's explicit pad
        self.conv = nn.utils.skip_init(nn.Conv2d, in_ch, out_ch, kernel, stride,
                                       padding=1 if kernel == 3 else 0, bias=not bn)
        self.bn = _bn(out_ch) if bn else None
        fan_in = in_ch * kernel * kernel
        with torch.no_grad():
            self.conv.weight.copy_(_uniform(self.conv.weight.shape, fan_in, generator))
            if not bn:
                self.conv.bias.copy_(_uniform(out_ch, fan_in, generator))

    def forward(self, x, act=None, rows=None, skip=None, add_first=False):
        """``rows`` (``parallel/spatial.py::Rows``) runs the conv with its
        halo and the BN with the moments of the mesh's batch; ``skip`` is
        added after the activation (a residual block's input), or before it
        with ``add_first`` (a ResNet bottleneck's shortcut)."""
        if rows is None:
            y = self.conv(x)
            if self.bn is not None:
                y = self.bn(y)
        else:
            c = self.conv
            y = rows.conv(x, c.weight, c.bias, c.stride[0], c.padding[0])
            if self.bn is not None:
                y = rows.bn(self.bn, y)
        return _activate(y, act, skip, add_first)

    def folded(self) -> Dict:
        """{"w": OIHW, "b"} with eval-mode BN folded in (``fold_conv_bn``)."""
        w = self.conv.weight.detach()
        if self.bn is None:
            return {"w": w, "b": self.conv.bias.detach()}
        return fold_conv_bn(
            {"w": w, "scale": self.bn.weight.detach(), "bias": self.bn.bias.detach()},
            {"mean": self.bn.running_mean, "var": self.bn.running_var})

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The block's parameters under the JAX tree's keys (``w`` OIHW, then
        ``b`` without BN or ``scale`` and ``bias`` with it), which
        ``models/convert.py``'s bridges read and write."""
        if self.bn is None:
            return {"w": self.conv.weight, "b": self.conv.bias}
        return {"w": self.conv.weight, "scale": self.bn.weight, "bias": self.bn.bias}

    def stat_leaves(self) -> Optional[Dict[str, torch.Tensor]]:
        """Its BN's running statistics under the JAX tree's keys; None
        without BN."""
        if self.bn is None:
            return None
        return {"mean": self.bn.running_mean, "var": self.bn.running_var}


def _activate(y, act, skip, add_first: bool):
    """``skip + act(y)``, or ``act(y + skip)`` with ``add_first``; no act
    is the identity and no skip adds nothing."""
    if add_first and skip is not None:
        y, skip = y + skip, None
    y = act(y) if act is not None else y
    return y if skip is None else skip + y


class PooledConvBlock(ConvBlock):
    """ResNet-vd's down-sampling shortcut in its training form: a 2x2
    average pool at stride 2 (ceil mode, as the source's; the sides here
    are even), then a 1x1 conv + BN. ``folded()`` makes it one 2x2 conv at
    stride 2 whose taps are the folded 1x1 weights over 4: the same
    function in real arithmetic, rounded once less."""

    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, 1, generator=generator)

    def forward(self, x, act=None, rows=None, skip=None, add_first=False):
        if rows is not None:
            raise ValueError("the pooled shortcut takes no rows: an RT-DETR plan has no SP")
        return super().forward(F.avg_pool2d(x, 2, 2, ceil_mode=True), act, None, skip,
                               add_first)

    def folded(self) -> Dict:
        main = super().folded()
        return {"w": main["w"].expand(-1, -1, 2, 2) / 4, "b": main["b"]}


class Linear(nn.Linear):
    """``nn.Linear`` as a leaf of the weight trees: ``w`` (out, in) and
    ``b``, the same in the trainable and the folded model (no BN to fold).
    Init as torch's: U(-1/sqrt(in), 1/sqrt(in)) for both, from
    ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        with torch.no_grad():
            self.weight.copy_(_uniform(self.weight.shape, in_features, generator))
            self.bias.copy_(_uniform(out_features, in_features, generator))

    def folded(self) -> Dict:
        return {"w": self.weight.detach(), "b": self.bias.detach()}

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {"w": self.weight, "b": self.bias}

    def stat_leaves(self) -> None:
        return None


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) as a leaf of the weight trees: ``w`` the
    scale, ``b`` the shift."""

    folded = Linear.folded
    leaves = Linear.leaves
    stat_leaves = Linear.stat_leaves


def _uniform(shape, fan_in: int, generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class RepConvBlock(ConvBlock):
    """YOLOv7's RepConv in its training form: ``act(BN(conv3x3(x)) +
    BN(conv1x1(x)) [+ BN(x)])``, the identity branch where ``in_ch ==
    out_ch``, the stride is 1 and ``identity`` (RT-DETR's RepVGG block has
    none: ``identity=False``). ``conv`` / ``bn`` are the 3x3 branch's
    (``ConvBlock``'s own), ``conv1x1`` / ``bn1x1`` the 1x1's, ``bn_id`` the
    identity's. ``folded()`` re-parameterises it into one 3x3 conv: each
    branch's BN folded into its kernel, the 1x1 kernel zero-padded into the
    3x3's centre, the identity a 3x3 kernel with a 1 at the centre of its own
    channel, the kernels and biases summed; the folded model's conv is then
    a plain 3x3 (``FoldedConv``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None, identity: bool = True):
        super().__init__(in_ch, out_ch, 3, stride, generator=generator)
        self.conv1x1 = nn.utils.skip_init(nn.Conv2d, in_ch, out_ch, 1, stride, bias=False)
        self.bn1x1 = _bn(out_ch)
        self.bn_id = _bn(in_ch) if identity and in_ch == out_ch and stride == 1 else None
        with torch.no_grad():
            self.conv1x1.weight.copy_(_uniform(self.conv1x1.weight.shape, in_ch, generator))

    def forward(self, x, act=None, rows=None):
        if rows is not None:
            raise ValueError("RepConv takes no rows: a YOLOv7 plan has no SP")
        y = self.bn(self.conv(x)) + self.bn1x1(self.conv1x1(x))
        if self.bn_id is not None:
            y = y + self.bn_id(x)
        return act(y) if act is not None else y

    def folded(self) -> Dict:
        main = super().folded()

        def fold(w, bn):
            return fold_conv_bn(
                {"w": w, "scale": bn.weight.detach(), "bias": bn.bias.detach()},
                {"mean": bn.running_mean, "var": bn.running_var})

        side = fold(self.conv1x1.weight.detach(), self.bn1x1)
        w, b = main["w"] + F.pad(side["w"], (1, 1, 1, 1)), main["b"] + side["b"]
        if self.bn_id is not None:
            c = w.shape[0]
            eye = torch.zeros_like(w)
            eye[torch.arange(c), torch.arange(c), 1, 1] = 1.0
            ident = fold(eye, self.bn_id)
            w, b = w + ident["w"], b + ident["b"]
        return {"w": w, "b": b}

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = {**super().leaves(), "w1x1": self.conv1x1.weight, "scale1x1": self.bn1x1.weight,
               "bias1x1": self.bn1x1.bias}
        if self.bn_id is not None:
            out.update(scale_id=self.bn_id.weight, bias_id=self.bn_id.bias)
        return out

    def stat_leaves(self) -> Dict[str, torch.Tensor]:
        out = {**super().stat_leaves(), "mean1x1": self.bn1x1.running_mean,
               "var1x1": self.bn1x1.running_var}
        if self.bn_id is not None:
            out.update(mean_id=self.bn_id.running_mean, var_id=self.bn_id.running_var)
        return out


class ImplicitConv(ConvBlock):
    """YOLOv7's IDetect output conv in its training form: ``m * (conv1x1(x +
    a) + bias)`` with the learned vectors ``implicit_a`` (ImplicitA, over the
    input channels, drawn N(0, 0.02)) and ``implicit_m`` (ImplicitM, over
    the output ones, N(1, 0.02)). ``folded()`` re-parameterises it into one
    1x1 with a bias: ``w' = m w``, ``b' = m (b + w a)``."""

    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, 1, bn=False, generator=generator)
        self.implicit_a = nn.Parameter(0.02 * torch.randn(in_ch, generator=generator))
        self.implicit_m = nn.Parameter(1 + 0.02 * torch.randn(out_ch, generator=generator))

    def forward(self, x, act=None, rows=None):
        if rows is not None:
            raise ValueError("the implicit conv takes no rows: a YOLOv7 plan has no SP")
        y = self.conv(x + self.implicit_a[:, None, None]) * self.implicit_m[:, None, None]
        return act(y) if act is not None else y

    def folded(self) -> Dict:
        w, b = self.conv.weight.detach(), self.conv.bias.detach()
        a, m = self.implicit_a.detach(), self.implicit_m.detach()
        return {"w": w * m[:, None, None, None], "b": m * (b + w[:, :, 0, 0] @ a)}

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {**super().leaves(), "implicit_a": self.implicit_a,
                "implicit_m": self.implicit_m}


def fold_conv_bn(params: Dict, stats: Dict) -> Dict:
    """Fold eval-mode BN into the conv: w' = w * g/sqrt(v+eps),
    b' = b - m*g/sqrt(v+eps). ``params['w']`` is OIHW."""
    inv = params["scale"] / torch.sqrt(stats["var"] + BN_EPS)
    w = params["w"] * inv[:, None, None, None]
    b = params["bias"] - stats["mean"] * inv
    return {"w": w, "b": b}


def epilogue_wins(x, act, skip=None) -> bool:
    """Whether a folded conv on input ``x`` runs its bias, activation
    ``act`` and residual add of ``skip`` as kernel K5 after a bias-free
    cuDNN conv: ``x`` (and ``skip``) bf16 on CUDA and stored channels_last,
    which is what the kernel takes and what a bf16 predictor on the card
    holds, and ``act`` one the kernel knows. Any other input (CPU, float32,
    NCHW memory) keeps the conv's bias, the activation and ``skip + y`` as
    separate ops."""
    return (act in EPILOGUE_ACTIVATIONS and _epilogue_takes(x)
            and (skip is None or _epilogue_takes(skip)))


def _epilogue_takes(t) -> bool:
    return t.is_cuda and t.dtype == torch.bfloat16 and t.is_contiguous(
        memory_format=torch.channels_last)


class FoldedConv(nn.Module):
    """Conv + bias (+ activation) (+ a residual) over BN-folded OIHW
    weights."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = 1 if kernel == 3 else 0
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_ch), requires_grad=False)

    def forward(self, x, act=None, rows=None, skip=None, add_first=False, out=None,
                keep=False):
        """``skip + act(conv(x) + bias)``, or ``act(conv(x) + bias + skip)``
        with ``add_first``; ``rows`` as ``ConvBlock``'s (SP keeps the
        separate ops). ``out``: a channel slice of a concat buffer
        (``ChannelConcat``) that takes the result, which K5 stores there
        itself (counted in ``profiling.concat_in_place_bytes``); with
        ``keep`` the result is also returned as a tensor of its own, for a
        later conv to read. Without K5 the result is copied in (counted in
        ``profiling.concat_bytes``)."""
        if rows is None and epilogue_wins(x, act, skip):
            y = conv2d(x, self.weight, self.stride, self.padding)
            order = {"add_first": True} if add_first else {}  # the Darknet order by default
            if out is not None:
                profiling.concat_in_place_bytes += out.numel() * out.element_size()
                order.update(out=out, keep=keep)
            return conv_epilogue(y, self.bias, EPILOGUE_ACTIVATIONS[act], skip, **order)
        if rows is None:
            y = conv2d(x, self.weight, self.stride, self.padding, bias=self.bias)
        else:
            y = rows.conv(x, self.weight, self.bias, self.stride, self.padding)
        y = _activate(y, act, skip, add_first)
        if out is None:
            return y
        _copy_into(out, y)
        return y if keep else out


def residual_blocks(width: int, hidden: int, n: int, conv) -> nn.ModuleList:
    """``n`` residual blocks, each a ``conv1`` (1x1, ``width`` -> ``hidden``)
    and a ``conv2`` (3x3, back to ``width``) made by ``conv(in_ch, out_ch,
    kernel)`` in that order: the JAX tree's ``blocks`` list."""
    return nn.ModuleList(
        nn.ModuleDict({"conv1": conv(width, hidden, 1), "conv2": conv(hidden, width, 3)})
        for _ in range(n)
    )


def cat_channels(parts):
    """``torch.cat`` along channels (NCHW); the bytes it writes are added to
    ``utils/profiling.py::concat_bytes``. Inputs stored channels_last give
    a channels_last result."""
    out = torch.cat(parts, dim=1)
    profiling.concat_bytes += out.nbytes
    return out


def concat_wins(x, act, folded: bool) -> bool:
    """Whether a channel concat whose parts are made from ``x`` is written
    in place (``ChannelConcat``): its conv parts come from ``FoldedConv``s
    (``folded``), K5 takes ``x`` and ``act`` (``epilogue_wins``: bf16 on
    CUDA, channels_last) and no gradient is asked of ``x``. The CPU,
    float32, the trainable model and autograd keep ``torch.cat`` (SP too:
    ``ChannelConcat`` takes its ``rows``)."""
    return (folded and epilogue_wins(x, act)
            and not (torch.is_grad_enabled() and x.requires_grad))


def _copy_into(slot, part) -> None:
    """One copy pass of ``part`` into its ``slot``, counted as concat bytes."""
    slot.copy_(part)
    profiling.concat_bytes += slot.numel() * slot.element_size()


class ChannelConcat:
    """The channel concat ``[part 0, part 1, ...]`` of (B, ``widths[i]``, H,
    W) parts (``size`` = (H, W)), handed in one by one in any order.

    Where ``concat_wins(like, act, folded)`` holds (and ``rows`` is None),
    the (B, sum(widths), H, W) channels_last buffer is allocated before any
    part and each part is written into its channel slice: a conv's result
    by K5 itself (``FoldedConv(..., out=slice)``), any other part by one
    copy, an upsampled one read from a broadcast view of its source. The
    concat then costs no pass of its own. Elsewhere the parts are kept and
    ``result()`` is ``cat_channels`` of them, as before."""

    def __init__(self, like, act, widths: Sequence[int], size: Tuple[int, int], folded: bool,
                 rows=None):
        self.parts = [None] * len(widths)
        self.starts = list(itertools.accumulate(widths, initial=0))
        self.buf = None
        if rows is None and concat_wins(like, act, folded):
            self.buf = torch.empty((like.shape[0], self.starts[-1], *size), dtype=like.dtype,
                                   device=like.device, memory_format=torch.channels_last)

    def _slot(self, i: int):
        return self.buf[:, self.starts[i]:self.starts[i + 1]]

    def conv(self, i: int, conv, x, act, keep: bool = False, **kw):
        """Part ``i`` is ``conv(x, act, **kw)``; with ``keep`` (a part a
        later conv reads too) it is returned as a dense tensor of its own."""
        if self.buf is None:
            self.parts[i] = conv(x, act, **kw)
            return self.parts[i]
        return conv(x, act, out=self._slot(i), keep=keep, **kw)

    def put(self, i: int, part) -> None:
        """Part ``i`` is ``part``, made elsewhere (a saved route)."""
        if self.buf is None:
            self.parts[i] = part
        else:
            _copy_into(self._slot(i), part)

    def upsampled(self, i: int, x) -> None:
        """Part ``i`` is ``upsample2x(x)``."""
        if self.buf is None:
            self.parts[i] = upsample2x(x)
            return
        b, c, h, w = x.shape
        nearest = x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
        _copy_into(self._slot(i).unflatten(3, (w, 2)).unflatten(2, (h, 2)), nearest)

    def result(self):
        """The concat: the buffer, or ``cat_channels`` of the parts."""
        return cat_channels(self.parts) if self.buf is None else self.buf


def upsample2x(x):
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def pool_wins(x) -> bool:
    """Whether a max pool of ``x`` runs as kernel K8: ``x`` bf16 on CUDA
    with no gradient asked of it (K8 has no backward). K8 takes it in any
    layout, width and size (``maxpool_kernel.apply_pyramid``,
    ``apply_maxpool2x2``). CPU, float32, s8 codes and a trainable module
    under autograd keep aten's pools."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and x.requires_grad))


def maxpool_pyramid(x, windows):
    """The stride-1 SAME max pools of ``windows`` (odd; 1 is ``x`` itself)
    side by side along channels, in that order: SPP's ``[pool13, pool9,
    pool5, x]`` and SPPCSPC's ``[x, pool5, pool9, pool13]``. K8's pyramid
    where ``pool_wins(x)``, which reads the plane once and writes the
    result itself, so no concat is counted; else aten's pools and their
    ``cat_channels``. Runs inside the program span ``forward.pool``."""
    with profiling.span("forward.pool"):
        if pool_wins(x):
            return maxpool_kernel.apply_pyramid(x, windows)
        return cat_channels(maxpool_kernel.pyramid_parts(x, windows))


def maxpool2d(x, kernel: int, stride: int):
    """NCHW max pool with the JAX ``maxpool2d`` padding: VALID for stride >
    1; SAME for stride 1, which pads k - 1 rows and columns, (k - 1) // 2
    before and the rest after (bottom and right only for a 2-wide window:
    torch's symmetric ``padding=`` cannot express it). Float tensors pad
    with -inf, integer tensors (the int8 path's s8 codes) with their dtype's
    minimum (``pool_valid``). Channels_last input gives channels_last
    output. What ``pool_wins`` takes runs as K8, whose 2x2 windows at stride
    2 and 1 are all that the models pool with here (YOLOv7's MP, tiny's
    pools); another window there raises. Runs inside the program span
    ``forward.pool``."""
    with profiling.span("forward.pool"):
        if pool_wins(x):
            if kernel != 2:
                raise ValueError(f"maxpool2d: K8 pools bf16 on the card in 2x2 windows, "
                                 f"got {kernel}x{kernel}")
            return maxpool_kernel.apply_maxpool2x2(x, stride)
        if stride == 1:
            before = (kernel - 1) // 2
            after = kernel - 1 - before
            fill = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
            x = F.pad(x, (before, after, before, after), value=fill)
        return pool_valid(x, kernel, stride)


def maxpool3x3s2(x):
    """NCHW max pool over 3x3 windows at stride 2 with a symmetric pad of 1
    (-inf), as ``F.max_pool2d(x, 3, 2, 1)``: the ResNet stem's. K8 where
    ``pool_wins(x)``, aten's pool elsewhere. Runs inside the program span
    ``forward.pool``."""
    with profiling.span("forward.pool"):
        if pool_wins(x):
            return maxpool_kernel.apply_maxpool3x3s2(x)
        return maxpool_kernel.maxpool3x3s2_reference(x)


def pool_valid(x, kernel: int, stride: int):
    """NCHW max pool with no padding. Float tensors pool with
    ``F.max_pool2d``; integer tensors take the maximum of the k * k strided
    views, which every device supports, and keep their dtype."""
    if x.is_floating_point():
        return F.max_pool2d(x, kernel, stride)
    h = (x.shape[2] - kernel) // stride + 1
    w = (x.shape[3] - kernel) // stride + 1
    out = None
    for i in range(kernel):
        for j in range(kernel):
            view = x[:, :, i : i + stride * (h - 1) + 1 : stride,
                     j : j + stride * (w - 1) + 1 : stride]
            out = view if out is None else torch.maximum(out, view)
    return out
