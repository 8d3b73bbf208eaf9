"""RT-DETR (Zhao et al., "DETRs Beat YOLOs on Real-time Object Detection",
arXiv:2304.08069), the ``rtdetr_r50vd`` model of lyuwenyu/RT-DETR
(``rtdetr_pytorch/configs/rtdetr/include/rtdetr_r50vd.yml``), as plan
entries and as modules over either conv kit (the trainable ``ConvBlock``
family or the folded ``FoldedConv``), in the manner of
``models/yolov7.py``. ``models/yolov3.py`` builds them from the layer list
(``RTDETR_LAYER_CONFIG``, the ``rtdetr_r50vd`` backbone) and walks them,
each inside its span: ``detr.backbone``, ``detr.encoder``,
``detr.decoder``.

- ``PlanResNetVd`` (``["resnet_vd", width, *depths]``): ResNet-50-vd. A
  stem of three 3x3 convs (``width / 2``, ``width / 2``, ``width``; the
  first at stride 2) under ReLU and a 3x3 max pool at stride 2 with a pad
  of 1 (``blocks.maxpool3x3s2``, K8 on the card); four stages of
  ``depths`` bottlenecks of width ``width * 2^i``, out ``4 * width *
  2^i``: ``relu(branch2c(branch2b(branch2a(x))) + short)``, the stride on
  the 3x3 (``branch2b``) of each stage's first block but the first
  stage's, the add before the ReLU (K5's add-first order). ``short`` is
  ``x``, or a 1x1 conv + BN in the first block of stage 1, or in the first
  block of stages 2-4 the ``d`` variant's 2x2 average pool at stride 2 and
  a 1x1 conv + BN, which folds to one 2x2 conv at stride 2
  (``blocks.PooledConvBlock``). Out: stages 2-4 (C3, C4, C5).
- ``PlanHybridEncoder`` (``["hybrid_encoder", hidden, heads, ffn,
  blocks]``): each level projected to ``hidden`` (1x1 conv + BN); AIFI, one
  post-norm transformer encoder layer over C5's tokens with the 2-D sin-cos
  position embedding added to the queries and keys (``pos_embed``) and an
  exact-erf GELU FFN; then CCFM under SiLU: top-down ``h5 = L0(P5)``, ``f4
  = CSPRep(cat[up2(h5), P4])``, ``h4 = L1(f4)``, ``f3 = CSPRep(cat[up2(h4),
  P3])``; bottom-up ``n4 = CSPRep(cat[D0(f3), h4])``, ``n5 =
  CSPRep(cat[D1(n4), h5])``. ``CSPRep(x) = RepVGG^blocks(conv1(x)) +
  conv2(x)`` (expansion 1.0: no conv3), the sum K5's skip on ``conv2``;
  RepVGG is ``silu(BN(conv3x3) + BN(conv1x1))`` with no identity
  (``RepConvBlock(identity=False)``), one 3x3 folded. Out: ``[f3, n4,
  n5]``.
- ``PlanDETRDecoder`` (``["detr_decoder", hidden, heads, levels, points,
  queries, layers, ffn]``, its first seven fields in order): each
  level projected (1x1 conv + BN) and flattened row-major into the memory
  ``M`` (8,400 tokens at 640px); the priors (``priors``); query selection
  (``O = LN(Linear(valid * M))``, scores ``Linear(O)``, ``coord =
  MLP3(O) + prior``, the top ``queries`` tokens by their best class score
  give the targets ``O[idx]`` and the references ``sigmoid(coord[idx])``);
  ``layers`` decoder layers, each ``LN(t + MHA(t + qp, t + qp, t))``,
  ``LN(t + MSDA(t + qp, ref, M))``, ``LN(t + W2 relu(W1 t))`` with ``qp =
  MLP2(ref)``, then ``ref = sigmoid(MLP3_l(t) + inv_sigmoid(ref))``; the
  last layer's class logits ``Linear_l(t)`` and its ``ref`` (cx, cy, w, h
  in [0, 1]) come out. The decoder reads the unmasked ``M``.

Precision: convs, linear layers, attention and the memory run in the
model's dtype (bf16 on the card); the box path is float32 (the priors,
``coord``, ``ref``, ``inv_sigmoid``, the refinement and the sampling
locations). On the card the deformable sampler is kernel K9
(``ops/kernels/deform_kernel.py``), which reads the bf16 values in place
and samples them at the float32 locations; its plain version, which casts
each level's values to float32 so that ``grid_sample`` takes them beside
the float32 grid, runs on the CPU and in float32 (``deform_wins``). The forward returns ``[logits, boxes, memory,
idx]``: ``inference.Predictor`` takes the top ``queries`` of
``sigmoid(logits)`` over queries x classes as its rows (``postprocess``),
without decode or NMS.

The modules' names are the source's (``backbone.res_layers.i.blocks.j.
branch2a``, ``encoder.encoder.0.layers.0.self_attn``,
``decoder.decoder.layers.k.cross_attn.sampling_offsets``, ...) below each
entry, so that the weight trees (``yolov3.conv_paths``) name their leaves
as a published checkpoint does. Where the port differs: a conv + BN is one
leaf (``w``, ``scale``, ``bias``, ``mean``, ``var``) where the source has
``conv`` and ``norm``; a RepVGG block one leaf (``RepConvBlock``'s
``w1x1`` ... for the source's ``conv2``); the ``d`` shortcut one leaf
``short`` for the source's ``short.conv``; an attention's ``in_proj`` a
``Linear`` for the source's ``in_proj_weight`` and ``in_proj_bias``.

Image sides must be multiples of 32 (the average pools' and the
upsamples' sides then match, as at the published 640px).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, ClassVar, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import deform_kernel
from ..utils import profiling
from .blocks import (
    ChannelConcat,
    ConvBlock,
    FoldedConv,
    LayerNorm,
    Linear,
    PooledConvBlock,
    RepConvBlock,
    maxpool3x3s2,
    relu,
    silu,
)

# rtdetr_r50vd: PResNet depth 50 variant d, HybridEncoder, RTDETRTransformer
RTDETR_LAYER_CONFIG = (
    ("resnet_vd", 64, 3, 4, 6, 3),
    ("hybrid_encoder", 256, 8, 1024, 3),
    ("detr_decoder", 256, 8, 3, 4, 300, 6, 1024),
)
PRIOR_SIZE = 0.05  # the priors' side at the finest level, doubling per level
PRIOR_EPS = 0.01  # a prior with a coordinate outside (eps, 1 - eps) is invalid
PE_TEMPERATURE = 10000.0


@dataclasses.dataclass(frozen=True)
class PlanResNetVd:
    in_ch: int
    width: int
    depths: Tuple[int, ...]
    family: ClassVar[str] = "RT-DETR"
    label: ClassVar[str] = "ResNet-vd backbone"
    span: ClassVar[str] = "detr.backbone"

    @property
    def out_chs(self) -> Tuple[int, ...]:
        """C3, C4, C5's channels."""
        return tuple(4 * self.width * 2 ** i for i in range(1, len(self.depths)))


@dataclasses.dataclass(frozen=True)
class PlanHybridEncoder:
    in_chs: Tuple[int, ...]
    hidden: int
    heads: int
    ffn: int
    blocks: int
    family: ClassVar[str] = "RT-DETR"
    label: ClassVar[str] = "hybrid encoder"
    span: ClassVar[str] = "detr.encoder"


@dataclasses.dataclass(frozen=True)
class PlanDETRDecoder:
    hidden: int
    heads: int
    levels: int
    points: int
    queries: int
    layers: int
    ffn: int
    in_ch: int
    num_classes: int
    family: ClassVar[str] = "RT-DETR"
    label: ClassVar[str] = "deformable decoder"
    span: ClassVar[str] = "detr.decoder"


DETR_ENTRIES = (PlanResNetVd, PlanHybridEncoder, PlanDETRDecoder)


def plan_entry(block, in_ch, num_classes: int):
    """The plan entry of one item of the layer list and what it hands on
    (channels, or each level's channels), or None for another item."""
    tag, args = block[0], tuple(block[1:])
    if tag == "resnet_vd":
        e = PlanResNetVd(in_ch, args[0], tuple(args[1:]))
        return e, e.out_chs
    if tag == "hybrid_encoder":
        e = PlanHybridEncoder(tuple(in_ch), *args)
        return e, (e.hidden,) * len(e.in_chs)
    if tag == "detr_decoder":
        e = PlanDETRDecoder(*args, in_ch=in_ch[0], num_classes=num_classes)
        if len(in_ch) != e.levels or len(set(in_ch)) != 1:
            raise ValueError(f"the decoder samples {e.levels} levels of one width, got {in_ch}")
        return e, None
    return None


# ---------------------------------------------------------------------------
# Conv kits: what each module is made of, trainable or folded
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Kit:
    """``conv(in, out, k, stride=1)`` (conv + BN), ``rep(in, out)`` (a
    RepVGG block), ``pooled(in, out)`` (the ``d`` shortcut), ``linear(in,
    out)`` and ``norm(features)``."""

    conv: Callable
    rep: Callable
    pooled: Callable
    linear: Callable
    norm: Callable


def trainable_kit(generator) -> Kit:
    g = generator
    return Kit(conv=lambda i, o, k, s=1: ConvBlock(i, o, k, s, generator=g),
               rep=lambda i, o: RepConvBlock(i, o, generator=g, identity=False),
               pooled=lambda i, o: PooledConvBlock(i, o, generator=g),
               linear=lambda i, o: Linear(i, o, generator=g),
               norm=LayerNorm)


FOLDED_KIT = Kit(conv=FoldedConv, rep=lambda i, o: FoldedConv(i, o, 3),
                 pooled=lambda i, o: FoldedConv(i, o, 2, 2), linear=Linear, norm=LayerNorm)


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int, short: str, kit: Kit):
        super().__init__()
        out = 4 * width
        self.branch2a = kit.conv(in_ch, width, 1)
        self.branch2b = kit.conv(width, width, 3, stride)
        self.branch2c = kit.conv(width, out, 1)
        if short == "conv":
            self.short = kit.conv(in_ch, out, 1)
        elif short == "pooled":
            self.short = kit.pooled(in_ch, out)
        else:
            self.short = None

    def forward(self, x):
        y = self.branch2b(self.branch2a(x, relu), relu)
        short = x if self.short is None else self.short(x)
        return self.branch2c(y, relu, skip=short, add_first=True)


class ResNetVd(nn.Module):
    def __init__(self, e: PlanResNetVd, kit: Kit):
        super().__init__()
        w = e.width
        self.conv1 = nn.ModuleDict({"conv1_1": kit.conv(e.in_ch, w // 2, 3, 2),
                                    "conv1_2": kit.conv(w // 2, w // 2, 3),
                                    "conv1_3": kit.conv(w // 2, w, 3)})
        stages, in_ch = [], w
        for i, n in enumerate(e.depths):
            width = w * 2 ** i
            first = ("conv", 1) if i == 0 else ("pooled", 2)
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                Bottleneck(in_ch if j == 0 else 4 * width, width, first[1] if j == 0 else 1,
                           first[0] if j == 0 else "identity", kit)
                for j in range(n))
            stages.append(stage)
            in_ch = 4 * width
        self.res_layers = nn.ModuleList(stages)

    def forward(self, x) -> List[torch.Tensor]:
        for conv in self.conv1.values():
            x = conv(x, relu)
        x = maxpool3x3s2(x)
        outs = []
        for stage in self.res_layers:
            for block in stage.blocks:
                x = block(x)
            outs.append(x)
        return outs[1:]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch first, no dropout) over
    ``F.scaled_dot_product_attention``: ``in_proj`` the q, k and v
    projections stacked (the source's ``in_proj_weight`` / ``_bias``),
    ``out_proj``. The queries and keys are one input here (``qk``), as in
    every use of it in RT-DETR."""

    def __init__(self, dim: int, heads: int, kit: Kit):
        super().__init__()
        self.heads = heads
        self.in_proj = kit.linear(dim, 3 * dim)
        self.out_proj = kit.linear(dim, dim)

    def forward(self, qk, v):
        b, n, e = v.shape
        w, bias = self.in_proj.weight, self.in_proj.bias
        q, k = F.linear(qk, w[: 2 * e], bias[: 2 * e]).view(b, n, 2, self.heads, -1) \
            .permute(2, 0, 3, 1, 4)
        v = F.linear(v, w[2 * e :], bias[2 * e :]).view(b, n, self.heads, -1).transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, e))


def pos_embed(h: int, w: int, dim: int, device) -> torch.Tensor:
    """(h * w, dim) float32: the source's ``build_2d_sincos_position_
    embedding(w, h)``, ``cat(sin(r om), cos(r om), sin(c om), cos(c om))``
    for token ``t = r * w + c`` with ``om_i = T^(-i / (dim / 4))``. The
    source's ``meshgrid(arange(w), arange(h), indexing="ij")`` makes its
    first half follow the row index ``r = t // w`` (for a square plane)."""
    quarter = dim // 4
    omega = 1.0 / PE_TEMPERATURE ** (torch.arange(quarter, dtype=torch.float32) / quarter)
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                            torch.arange(h, dtype=torch.float32), indexing="ij")
    ow, oh = gw.flatten()[:, None] * omega, gh.flatten()[:, None] * omega
    return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1).to(device)


class EncoderLayer(nn.Module):
    """AIFI's post-norm transformer encoder layer."""

    def __init__(self, dim: int, heads: int, ffn: int, kit: Kit):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads, kit)
        self.linear1 = kit.linear(dim, ffn)
        self.linear2 = kit.linear(ffn, dim)
        self.norm1 = kit.norm(dim)
        self.norm2 = kit.norm(dim)

    def forward(self, s, pos):
        s = self.norm1(s + self.self_attn(s + pos, s))
        return self.norm2(s + self.linear2(F.gelu(self.linear1(s))))


# ---------------------------------------------------------------------------
# Hybrid encoder
# ---------------------------------------------------------------------------


class CSPRep(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, blocks: int, kit: Kit):
        super().__init__()
        self.conv1 = kit.conv(in_ch, out_ch, 1)
        self.conv2 = kit.conv(in_ch, out_ch, 1)
        self.bottlenecks = nn.ModuleList(kit.rep(out_ch, out_ch) for _ in range(blocks))

    def forward(self, x):
        y = self.conv1(x, silu)
        for block in self.bottlenecks:
            y = block(y, silu)
        return self.conv2(x, silu, skip=y)


class HybridEncoder(nn.Module):
    def __init__(self, e: PlanHybridEncoder, kit: Kit):
        super().__init__()
        h, n = e.hidden, len(e.in_chs)
        self.hidden = h
        self.input_proj = nn.ModuleList(kit.conv(c, h, 1) for c in e.in_chs)
        aifi = nn.Module()
        aifi.layers = nn.ModuleList([EncoderLayer(h, e.heads, e.ffn, kit)])
        self.encoder = nn.ModuleList([aifi])
        self.lateral_convs = nn.ModuleList(kit.conv(h, h, 1) for _ in range(n - 1))
        self.fpn_blocks = nn.ModuleList(CSPRep(2 * h, h, e.blocks, kit) for _ in range(n - 1))
        self.downsample_convs = nn.ModuleList(kit.conv(h, h, 3, 2) for _ in range(n - 1))
        self.pan_blocks = nn.ModuleList(CSPRep(2 * h, h, e.blocks, kit) for _ in range(n - 1))
        self._pos = {}

    def _pos_embed(self, h: int, w: int, like: torch.Tensor) -> torch.Tensor:
        key = (h, w, like.device, like.dtype)
        if key not in self._pos:
            self._pos[key] = pos_embed(h, w, self.hidden, like.device).to(like.dtype)
        return self._pos[key]

    def forward(self, feats) -> List[torch.Tensor]:
        """CCFM's concats are ``blocks.ChannelConcat``s: the top-down one
        takes the upsampled lateral output by a copy and the level's input
        projection from K5, the bottom-up one the stride-2 conv from K5 and
        the top-down output by a copy."""
        hidden = self.hidden
        folded = isinstance(self.input_proj[0], FoldedConv)
        top = self.input_proj[-1](feats[-1])
        b, c, h, w = top.shape
        # channels_last storage is (B, H, W, C): the tokens row-major, free
        s = top.permute(0, 2, 3, 1).reshape(b, h * w, c)
        s = self.encoder[0].layers[0](s, self._pos_embed(h, w, s))
        inner = [s.view(b, h, w, c).permute(0, 3, 1, 2)]
        for k, idx in enumerate(range(len(feats) - 1, 0, -1)):
            high = self.lateral_convs[k](inner[0], silu)
            inner[0] = high
            f = feats[idx - 1]
            cat = ChannelConcat(f, None, (hidden, hidden), f.shape[2:], folded)
            cat.upsampled(0, high)
            cat.conv(1, self.input_proj[idx - 1], f, None)
            inner.insert(0, self.fpn_blocks[k](cat.result()))
        outs = [inner[0]]
        for k in range(len(feats) - 1):
            cat = ChannelConcat(outs[-1], silu, (hidden, hidden), inner[k + 1].shape[2:],
                                folded)
            cat.conv(0, self.downsample_convs[k], outs[-1], silu)
            cat.put(1, inner[k + 1])
            outs.append(self.pan_blocks[k](cat.result()))
        return outs


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Linear layers with ReLU between them (none after the last)."""

    def __init__(self, dims: Tuple[int, ...], kit: Kit):
        super().__init__()
        self.layers = nn.ModuleList(kit.linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def inv_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The source's ``inverse_sigmoid``: ``log(x / (1 - x))`` with x
    clipped to [0, 1] and both terms to at least ``eps``."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def priors(shapes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """((1, N, 4) float32 logits, (1, N, 1) bool valid): at level ``l`` of
    ``(h, w)`` the cell in row ``i``, column ``j`` has ``p = ((j + .5) / w,
    (i + .5) / h, s 2^l, s 2^l)`` with ``s = PRIOR_SIZE``; valid where every
    coordinate lies in ``(PRIOR_EPS, 1 - PRIOR_EPS)``, its logit
    ``log(p / (1 - p))``, else +inf."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        xy = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([w, h], dtype=torch.float32)
        wh = torch.full_like(xy, PRIOR_SIZE * 2.0 ** lvl)
        out.append(torch.cat([xy, wh], -1).reshape(1, h * w, 4))
    p = torch.cat(out, 1)
    valid = ((p > PRIOR_EPS) & (p < 1 - PRIOR_EPS)).all(-1, keepdim=True)
    logit = torch.where(valid, torch.log(p / (1 - p)), torch.full_like(p, math.inf))
    return logit.to(device), valid.to(device)


class MSDeformableAttention(nn.Module):
    """Multi-scale deformable attention (Deformable DETR, arXiv:2010.04159)
    with 4-d references: ``heads x levels x points`` bilinear samples of the
    projected memory around each query's box, weighted by a softmax over
    each head's ``levels x points``. The sampling core (``grid_sample`` at
    ``2 loc - 1`` with ``align_corners=False`` and zero padding, and the
    weighted sum: K9 where ``deform_wins``, else its plain version) runs
    inside the program span ``detr.deform`` and adds its samples to
    ``utils/profiling.py::deform_samples``."""

    def __init__(self, dim: int, heads: int, levels: int, points: int, kit: Kit):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.sampling_offsets = kit.linear(dim, heads * levels * points * 2)
        self.attention_weights = kit.linear(dim, heads * levels * points)
        self.value_proj = kit.linear(dim, dim)
        self.output_proj = kit.linear(dim, dim)

    def forward(self, query, ref, memory, shapes):
        b, q, _ = query.shape
        hd, lv, pt = self.heads, self.levels, self.points
        value = self.value_proj(memory)
        off = self.sampling_offsets(query).view(b, q, hd, lv, pt, 2).float()
        weights = F.softmax(self.attention_weights(query).view(b, q, hd, lv * pt).float(), -1)
        loc = ref[:, :, None, None, None, :2] + off / pt * ref[:, :, None, None, None, 2:] * 0.5
        with profiling.span("detr.deform"):
            if deform_wins(value):
                out = deform_kernel.deform_attention(value, shapes, loc.contiguous(), weights)
            else:
                out = deform_kernel.deform_attention_reference(value, shapes, loc, weights)
            profiling.deform_samples += b * q * hd * lv * pt
        return self.output_proj(out.to(query.dtype))


def deform_wins(value) -> bool:
    """Whether the sampling core runs as kernel K9: bf16 values on CUDA
    (what a bf16 predictor on the card holds). The CPU and float32 keep the
    plain version."""
    return value.is_cuda and value.dtype == torch.bfloat16


class DecoderLayer(nn.Module):
    def __init__(self, e: PlanDETRDecoder, kit: Kit):
        super().__init__()
        self.self_attn = MultiheadAttention(e.hidden, e.heads, kit)
        self.norm1 = kit.norm(e.hidden)
        self.cross_attn = MSDeformableAttention(e.hidden, e.heads, e.levels, e.points, kit)
        self.norm2 = kit.norm(e.hidden)
        self.linear1 = kit.linear(e.hidden, e.ffn)
        self.linear2 = kit.linear(e.ffn, e.hidden)
        self.norm3 = kit.norm(e.hidden)

    def forward(self, tgt, qp, ref, memory, shapes):
        tgt = self.norm1(tgt + self.self_attn(tgt + qp, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + qp, ref, memory, shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class DETRDecoder(nn.Module):
    def __init__(self, e: PlanDETRDecoder, kit: Kit):
        super().__init__()
        h = e.hidden
        self.entry = e
        self.input_proj = nn.ModuleList(kit.conv(e.in_ch, h, 1) for _ in range(e.levels))
        stack = nn.Module()
        stack.layers = nn.ModuleList(DecoderLayer(e, kit) for _ in range(e.layers))
        self.decoder = stack
        self.query_pos_head = MLP((4, 2 * h, h), kit)
        self.enc_output = nn.Sequential(kit.linear(h, h), kit.norm(h))
        self.enc_score_head = kit.linear(h, e.num_classes)
        self.enc_bbox_head = MLP((h, h, h, 4), kit)
        self.dec_score_head = nn.ModuleList(kit.linear(h, e.num_classes) for _ in range(e.layers))
        self.dec_bbox_head = nn.ModuleList(MLP((h, h, h, 4), kit) for _ in range(e.layers))
        self._priors = {}

    def _priors_for(self, shapes, device):
        key = (tuple(shapes), device)
        if key not in self._priors:
            self._priors[key] = priors(shapes, device)
        return self._priors[key]

    def memory(self, feats):
        """((B, N, hidden) memory, each level's (h, w))."""
        tokens, shapes = [], []
        for conv, f in zip(self.input_proj, feats):
            y = conv(f)
            b, c, h, w = y.shape
            tokens.append(y.permute(0, 2, 3, 1).reshape(b, h * w, c))
            shapes.append((h, w))
        return torch.cat(tokens, 1), shapes

    def select(self, memory, shapes):
        """(idx (B, Q), targets (B, Q, hidden), references (B, Q, 4)
        float32): the encoder head's top queries."""
        logit, valid = self._priors_for(shapes, memory.device)
        out = self.enc_output(valid.to(memory.dtype) * memory)
        score = self.enc_score_head(out)
        coord = self.enc_bbox_head(out).float() + logit
        idx = torch.topk(score.max(-1).values, self.entry.queries, dim=1).indices
        tgt = torch.gather(out, 1, idx[..., None].expand(-1, -1, out.shape[-1]))
        ref = torch.sigmoid(torch.gather(coord, 1, idx[..., None].expand(-1, -1, 4)))
        return idx, tgt, ref

    def decode(self, tgt, ref, memory, shapes):
        """(logits (B, Q, classes), boxes (B, Q, 4) float32) of the decoder
        layers from the selected targets and references."""
        for k, layer in enumerate(self.decoder.layers):
            qp = self.query_pos_head(ref.to(tgt.dtype))
            tgt = layer(tgt, qp, ref, memory, shapes)
            ref = torch.sigmoid(self.dec_bbox_head[k](tgt).float() + inv_sigmoid(ref))
        return self.dec_score_head[len(self.decoder.layers) - 1](tgt), ref

    def forward(self, feats) -> List[torch.Tensor]:
        memory, shapes = self.memory(feats)
        idx, tgt, ref = self.select(memory, shapes)
        logits, boxes = self.decode(tgt, ref, memory, shapes)
        return [logits, boxes, memory, idx]


LAYERS = {PlanResNetVd: ResNetVd, PlanHybridEncoder: HybridEncoder, PlanDETRDecoder: DETRDecoder}


def layer(entry, kit: Kit) -> nn.Module:
    return LAYERS[type(entry)](entry, kit)


def postprocess(logits: torch.Tensor, boxes: torch.Tensor, k: int, threshold: float):
    """((B, k, 6) float32 rows ``[cx, cy, w, h, score, class]`` by
    descending score, (B, k) bool ``score >= threshold``): the top ``k`` of
    ``sigmoid(logits)`` over queries x classes, class ``i % C`` of query
    ``i // C`` (the source's ``RTDETRPostProcessor`` with focal scores,
    keeping its normalised cxcywh boxes)."""
    c = logits.shape[-1]
    score, i = torch.topk(torch.sigmoid(logits.float()).flatten(1), k, dim=1)
    box = torch.gather(boxes, 1, torch.div(i, c, rounding_mode="floor")[..., None].expand(-1, -1, 4))
    rows = torch.cat([box, score[..., None], (i % c)[..., None].float()], -1)
    return rows, score >= threshold


def decoder_entry(plan):
    """The plan's ``PlanDETRDecoder``, or None for a plan without one (a
    YOLO family's)."""
    return next((e for e in plan if isinstance(e, PlanDETRDecoder)), None)
