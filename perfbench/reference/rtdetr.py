"""Plain float32 RT-DETR-R50 in PyTorch: the benchmark's reference for the
``rtdetr-r50vd-coco640`` configuration (Zhao et al., "DETRs Beat YOLOs on
Real-time Object Detection", arXiv:2304.08069; lyuwenyu/RT-DETR
``rtdetr_pytorch/configs/rtdetr/include/rtdetr_r50vd.yml``).

It reads the configuration's layer list (``["resnet_vd", width,
*depths]``, ``["hybrid_encoder", hidden, heads, ffn, blocks]``,
``["detr_decoder", hidden, heads, levels, points, queries, layers, ffn]``)
and computes, with torch operations alone (TF32 off: ``model.exact_f32``):

Notation: ``CBA(c, k, s, act)`` is a conv with pad ``(k - 1) // 2`` and no
bias, then BN, then ``act``; ``sig`` the logistic function;
``inv_sig(x) = log(clip(x, 0, 1).clamp_min(1e-5) / (1 - clip(x, 0,
1)).clamp_min(1e-5))``.

Backbone, ResNet-50-vd (PResNet depth 50, variant d, ``return_idx [1, 2,
3]``): a stem ``CBA(w/2, 3, 2, relu) -> CBA(w/2, 3, 1, relu) -> CBA(w, 3,
1, relu) -> maxpool 3x3 s2 p1``; stages of ``depths`` bottlenecks of width
``w 2^i``: ``y = CBA(4 w_i, 1, 1, none)(CBA(w_i, 3, s, relu)(CBA(w_i, 1, 1,
relu)(x)))``, ``out = relu(y + short)``, ``s`` 2 in the first block of
stages 2-4; ``short`` is ``x``, ``CBA(4 w_i, 1, 1, none)(x)`` in the first
block of stage 1, ``CBA(4 w_i, 1, 1, none)(avgpool2x2s2(x))`` in the first
block of stages 2-4 (ceil mode; the sides here are even). Out C3, C4, C5.

Hybrid encoder (SiLU): ``P_i = BN(conv1x1(C_i, hidden))``; AIFI on P5's
tokens ``s`` (row-major): ``q = k = s + pos``, ``s = LN(s + MHA(q, k,
s))``, ``s = LN(s + W2 GELU_erf(W1 s))``; ``pos[t] = cat(sin(r om), cos(r
om), sin(c om), cos(c om))``, ``om_i = 10000^(-i / (hidden / 4))``, ``r = t
// W``, ``c = t % W`` (the source's ``meshgrid(w, h, indexing="ij")``, whose
"w" half follows the row on a square plane). ``CSPRep(x) = RepVGG^n(CBA(h,
1, 1, silu)(x)) + CBA(h, 1, 1, silu)(x)``, ``RepVGG(z) = silu(BN(conv3x3
z) + BN(conv1x1 z))`` with no identity branch; ``L_i = CBA(h, 1, 1, silu)``,
``D_i = CBA(h, 3, 2, silu)``: ``h5 = L0(P5)``, ``f4 = CSPRep(cat[up2(h5),
P4])``, ``h4 = L1(f4)``, ``f3 = CSPRep(cat[up2(h4), P3])``, ``n4 =
CSPRep(cat[D0(f3), h4])``, ``n5 = CSPRep(cat[D1(n4), h5])``; out ``[f3, n4,
n5]``.

Decoder: the memory ``M`` is ``BN(conv1x1)`` of each output flattened and
concatenated (row-major per level); priors at level ``l`` of side ``S``:
``p = ((j + .5) / S, (i + .5) / S, 0.05 2^l, 0.05 2^l)``, ``a = log(p / (1
- p))`` where every coordinate lies in (0.01, 0.99), else +inf; ``O =
LN(Linear(valid M))``, ``score = Linear_C(O)``, ``coord = MLP3(O) + a``,
``idx = topk(max_c score, Q)``, ``tgt = O[idx]``, ``ref = sig(coord[idx])``
(the decoder reads the unmasked ``M``); each layer, with ``qp = MLP2(ref)``:
``tgt = LN(tgt + MHA(tgt + qp, tgt + qp, tgt))``, ``tgt = LN(tgt +
MSDA(tgt + qp, ref, M))``, ``tgt = LN(tgt + W2 relu(W1 tgt))``, ``ref =
sig(MLP3_l(tgt) + inv_sig(ref))``; after the last, ``logits =
Linear_C,l(tgt)``, ``boxes = ref``. ``MSDA(q, ref, M)``: ``V =
value_proj(M)`` per level as (B heads, d, H_l, W_l); ``off = Linear(q)``
(heads, levels, points, 2); ``w`` a softmax over each head's (level, point)
pairs of ``Linear(q)``; ``loc = ref.xy + off / points * ref.wh * 0.5``;
``out = output_proj(sum w bilinear(V_l, loc))``, bilinear being
``grid_sample(V_l, 2 loc - 1, align_corners=False)`` with zero padding.
Postprocess: the top ``Q`` of ``sig(logits)`` over queries x classes, class
``k % C`` of query ``k // C``.

Departures from the source, each also in the configuration's ``assumed``:
the rows are normalised ``[cx, cy, w, h, score, class]`` (the source
returns pixel xyxy boxes, labels and scores), and the kept rows are those
whose score is at least the configuration's ``conf_threshold``; the
training-only denoising queries are absent, as in the source at inference.

Functions: :func:`unfused_forward` (conv + BN, RepVGG's two branches and the
``d`` shortcut's pool + 1x1, from the unfused tree), :func:`reparameterise`
(BN folded, RepVGG's branches summed into one 3x3; the shortcut keeps its
pool), :func:`folded_forward` returning ``(memory, idx, logits, boxes)``,
:func:`decoder_from` (the decoder from given indices: the check's
teacher-forced path), :func:`postprocess`, :func:`forward_flops` and
:func:`epilogue_bytes`. ``quant`` (the control's lower precision) is
applied to every conv's and every linear layer's input and weight when
given.

The unfused tree is a dict from the source's module names (``backbone.
res_layers.1.blocks.0.branch2b``, ``encoder.encoder.0.layers.0.self_attn.
in_proj``, ``decoder.decoder.layers.5.cross_attn.sampling_offsets``, ...)
to leaves: a conv + BN ``{w (OIHW), gamma, beta, mean, var}``, a RepVGG
block the same plus ``w1x1``, ``gamma1x1``, ``beta1x1``, ``mean1x1``,
``var1x1``; a linear layer ``{w (out, in), b}``; a layer norm ``{w, b}``.
The folded tree has ``{w, b}`` per conv and the same linear and norm leaves.

It imports nothing of the measured program.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-5
PRIOR_SIZE, PRIOR_EPS = 0.05, 0.01
PE_TEMPERATURE = 10000.0


def sizes(cfg: dict) -> dict:
    """The layer list's sizes by name."""
    items = {item[0]: list(item[1:]) for item in cfg["layers"]}
    width, *depths = items["resnet_vd"]
    hidden, heads, ffn, blocks = items["hybrid_encoder"]
    d_hidden, d_heads, levels, points, queries, layers, d_ffn = items["detr_decoder"]
    if d_hidden != hidden or levels != 3:
        raise ValueError("the decoder samples the encoder's three levels at its width")
    return {"in": cfg["in_channels"], "width": width, "depths": depths, "hidden": hidden,
            "heads": heads, "ffn": ffn, "blocks": blocks, "d_heads": d_heads,
            "levels": levels, "points": points, "queries": queries, "layers": layers,
            "d_ffn": d_ffn, "classes": cfg["num_classes"]}


def leaf_specs(cfg: dict) -> List[dict]:
    """Every leaf of the unfused tree in the order of the source's modules:
    ``{"name", "kind"}`` with ``kind`` ``conv`` / ``rep`` / ``pooled``
    (``cin``, ``cout``, ``k``), ``linear`` (``cin``, ``cout``) or ``norm``
    (``n``); a conv's ``gain`` is ``branch`` on a bottleneck's last conv."""
    z = sizes(cfg)
    out = []

    def conv(name, cin, cout, k, kind="conv", gain=None):
        out.append({"name": name, "kind": kind, "cin": cin, "cout": cout, "k": k, "gain": gain})

    def linear(name, cin, cout):
        out.append({"name": name, "kind": "linear", "cin": cin, "cout": cout})

    def norm(name, n):
        out.append({"name": name, "kind": "norm", "n": n})

    def mha(name, e):
        linear(name + ".in_proj", e, 3 * e)
        linear(name + ".out_proj", e, e)

    def mlp(name, dims):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            linear(f"{name}.layers.{i}", a, b)

    w = z["width"]
    conv("backbone.conv1.conv1_1", z["in"], w // 2, 3)
    conv("backbone.conv1.conv1_2", w // 2, w // 2, 3)
    conv("backbone.conv1.conv1_3", w // 2, w, 3)
    cin = w
    for i, n in enumerate(z["depths"]):
        wi = w * 2 ** i
        for j in range(n):
            p = f"backbone.res_layers.{i}.blocks.{j}"
            conv(p + ".branch2a", cin, wi, 1)
            conv(p + ".branch2b", wi, wi, 3)
            conv(p + ".branch2c", wi, 4 * wi, 1, gain="branch")
            if j == 0:
                conv(p + ".short", cin, 4 * wi, 1, "conv" if i == 0 else "pooled")
            cin = 4 * wi
    h = z["hidden"]
    outs = [4 * w * 2 ** i for i in range(1, len(z["depths"]))]
    for i, c in enumerate(outs):
        conv(f"encoder.input_proj.{i}", c, h, 1)
    p = "encoder.encoder.0.layers.0"
    mha(p + ".self_attn", h)
    linear(p + ".linear1", h, z["ffn"])
    linear(p + ".linear2", z["ffn"], h)
    norm(p + ".norm1", h)
    norm(p + ".norm2", h)
    n = len(outs) - 1
    for k in range(n):
        conv(f"encoder.lateral_convs.{k}", h, h, 1)
    for part in ("fpn_blocks", "pan_blocks"):
        for k in range(n):
            p = f"encoder.{part}.{k}"
            conv(p + ".conv1", 2 * h, h, 1)
            conv(p + ".conv2", 2 * h, h, 1)
            for j in range(z["blocks"]):
                conv(f"{p}.bottlenecks.{j}", h, h, 3, "rep")
        if part == "fpn_blocks":
            for k in range(n):
                conv(f"encoder.downsample_convs.{k}", h, h, 3)
    for i in range(z["levels"]):
        conv(f"decoder.input_proj.{i}", h, h, 1)
    for k in range(z["layers"]):
        p = f"decoder.decoder.layers.{k}"
        mha(p + ".self_attn", h)
        norm(p + ".norm1", h)
        hlp = z["d_heads"] * z["levels"] * z["points"]
        linear(p + ".cross_attn.sampling_offsets", h, 2 * hlp)
        linear(p + ".cross_attn.attention_weights", h, hlp)
        linear(p + ".cross_attn.value_proj", h, h)
        linear(p + ".cross_attn.output_proj", h, h)
        norm(p + ".norm2", h)
        linear(p + ".linear1", h, z["d_ffn"])
        linear(p + ".linear2", z["d_ffn"], h)
        norm(p + ".norm3", h)
    mlp("decoder.query_pos_head", (4, 2 * h, h))
    linear("decoder.enc_output.0", h, h)
    norm("decoder.enc_output.1", h)
    linear("decoder.enc_score_head", h, z["classes"])
    mlp("decoder.enc_bbox_head", (h, h, h, 4))
    for k in range(z["layers"]):
        linear(f"decoder.dec_score_head.{k}", h, z["classes"])
    for k in range(z["layers"]):
        mlp(f"decoder.dec_bbox_head.{k}", (h, h, h, 4))
    return out


# ---------------------------------------------------------------------------
# The forward, over either tree
# ---------------------------------------------------------------------------


def _bn(y, p: dict, suffix: str = ""):
    inv = p["gamma" + suffix] / torch.sqrt(p["var" + suffix] + BN_EPS)
    return (y - p["mean" + suffix][None, :, None, None]) * inv[None, :, None, None] \
        + p["beta" + suffix][None, :, None, None]


def _calibrate(y, p: dict, suffix: str = "") -> None:
    """Set a BN's statistics to those of ``y`` over (N, H, W) (biased)."""
    p["mean" + suffix] = y.mean(dim=(0, 2, 3))
    p["var" + suffix] = y.var(dim=(0, 2, 3), unbiased=False)


class Net:
    """The forward over ``tree``: ``folded`` (``{w, b}`` convs) or not (conv
    + BN leaves), ``quant`` on every conv's and linear layer's input and
    weight, ``calibrate`` setting each BN's statistics from its own input
    on the way (the unfused tree only)."""

    def __init__(self, cfg: dict, tree: dict, folded: bool, quant=None, calibrate: bool = False):
        self.z, self.tree, self.folded = sizes(cfg), tree, folded
        self.quant = quant or (lambda t: t)
        self.calibrate = calibrate

    def conv(self, name, x, stride=1, act=None, skip=None, first=False, kind="conv"):
        p = self.tree[name]
        if kind == "pooled":
            x = F.avg_pool2d(x, 2, 2, ceil_mode=True)
        q = self.quant(x)

        def raw(w, b=None):
            return F.conv2d(q, self.quant(w), b, stride=stride, padding=(w.shape[-1] - 1) // 2)

        if self.folded:
            y = raw(p["w"], p["b"])
        else:
            y = raw(p["w"])
            if self.calibrate:
                _calibrate(y, p)
            y = _bn(y, p)
            if kind == "rep":
                y1 = raw(p["w1x1"])
                if self.calibrate:
                    _calibrate(y1, p, "1x1")
                y = y + _bn(y1, p, "1x1")
        if first and skip is not None:
            y, skip = y + skip, None
        y = act(y) if act is not None else y
        return y if skip is None else y + skip

    def linear(self, name, x):
        p = self.tree[name]
        return F.linear(self.quant(x), self.quant(p["w"]), p["b"])

    def linear_rows(self, name, x, rows: slice):
        p = self.tree[name]
        return F.linear(self.quant(x), self.quant(p["w"][rows]), p["b"][rows])

    def norm(self, name, x):
        p = self.tree[name]
        return F.layer_norm(x, (x.shape[-1],), p["w"], p["b"], LN_EPS)

    def mlp(self, name, x, n):
        for i in range(n):
            x = self.linear(f"{name}.layers.{i}", x)
            if i < n - 1:
                x = torch.relu(x)
        return x

    def mha(self, name, qk, v, heads):
        b, n, e = v.shape
        d = e // heads
        q = self.linear_rows(name + ".in_proj", qk, slice(0, e))
        k = self.linear_rows(name + ".in_proj", qk, slice(e, 2 * e))
        vv = self.linear_rows(name + ".in_proj", v, slice(2 * e, 3 * e))
        q, k, vv = (t.view(b, n, heads, d).transpose(1, 2) for t in (q, k, vv))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), -1)
        return self.linear(name + ".out_proj", (att @ vv).transpose(1, 2).reshape(b, n, e))

    # -- backbone --------------------------------------------------------

    def backbone(self, x) -> List[torch.Tensor]:
        relu = torch.relu
        for k in ("conv1_1", "conv1_2", "conv1_3"):
            x = self.conv(f"backbone.conv1.{k}", x, 2 if k == "conv1_1" else 1, relu)
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i, n in enumerate(self.z["depths"]):
            for j in range(n):
                p = f"backbone.res_layers.{i}.blocks.{j}"
                s = 2 if i > 0 and j == 0 else 1
                y = self.conv(p + ".branch2a", x, 1, relu)
                y = self.conv(p + ".branch2b", y, s, relu)
                if j == 0:
                    short = self.conv(p + ".short", x, 1, kind="conv" if i == 0 else "pooled")
                else:
                    short = x
                x = self.conv(p + ".branch2c", y, 1, relu, skip=short, first=True)
            outs.append(x)
        return outs[1:]

    # -- encoder ---------------------------------------------------------

    def csp(self, name, x):
        silu = F.silu
        y = self.conv(name + ".conv1", x, 1, silu)
        for j in range(self.z["blocks"]):
            y = self.conv(f"{name}.bottlenecks.{j}", y, 1, silu, kind="rep")
        return y + self.conv(name + ".conv2", x, 1, silu)

    def encoder(self, feats) -> List[torch.Tensor]:
        silu = F.silu
        h = self.z["hidden"]
        proj = [self.conv(f"encoder.input_proj.{i}", f) for i, f in enumerate(feats)]
        top = proj[-1]
        b, _, hh, ww = top.shape
        s = top.flatten(2).permute(0, 2, 1)
        pos = pos_table(hh, ww, h).to(s.device)
        p = "encoder.encoder.0.layers.0"
        s = self.norm(p + ".norm1", s + self.mha(p + ".self_attn", s + pos, s, self.z["heads"]))
        ffn = self.linear(p + ".linear2", F.gelu(self.linear(p + ".linear1", s)))
        s = self.norm(p + ".norm2", s + ffn)
        proj[-1] = s.permute(0, 2, 1).reshape(b, h, hh, ww)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        h5 = self.conv("encoder.lateral_convs.0", proj[2], 1, silu)
        f4 = self.csp("encoder.fpn_blocks.0", torch.cat([up(h5), proj[1]], 1))
        h4 = self.conv("encoder.lateral_convs.1", f4, 1, silu)
        f3 = self.csp("encoder.fpn_blocks.1", torch.cat([up(h4), proj[0]], 1))
        n4 = self.csp("encoder.pan_blocks.0",
                      torch.cat([self.conv("encoder.downsample_convs.0", f3, 2, silu), h4], 1))
        n5 = self.csp("encoder.pan_blocks.1",
                      torch.cat([self.conv("encoder.downsample_convs.1", n4, 2, silu), h5], 1))
        return [f3, n4, n5]

    # -- decoder ---------------------------------------------------------

    def memory(self, feats) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
        tokens, shapes = [], []
        for i, f in enumerate(feats):
            y = self.conv(f"decoder.input_proj.{i}", f)
            tokens.append(y.flatten(2).permute(0, 2, 1))
            shapes.append(tuple(y.shape[2:]))
        return torch.cat(tokens, 1), shapes

    def selection_head(self, memory, shapes):
        """(O, score, coord) of every token."""
        logit, valid = priors(shapes, memory.device)
        out = self.norm("decoder.enc_output.1", self.linear("decoder.enc_output.0",
                                                            valid.float() * memory))
        score = self.linear("decoder.enc_score_head", out)
        coord = self.mlp("decoder.enc_bbox_head", out, 3) + logit
        return out, score, coord

    def msda(self, name, query, ref, memory, shapes):
        z = self.z
        b, q, _ = query.shape
        hd, lv, pt = z["d_heads"], z["levels"], z["points"]
        value = self.linear(name + ".value_proj", memory)
        off = self.linear(name + ".sampling_offsets", query).view(b, q, hd, lv, pt, 2)
        w = torch.softmax(self.linear(name + ".attention_weights", query).view(b, q, hd, lv * pt),
                          -1).view(b, q, hd, lv, pt)
        loc = ref[:, :, None, None, None, :2] + off / pt * ref[:, :, None, None, None, 2:] * 0.5
        return self.linear(name + ".output_proj", deform_core(value, shapes, loc, w))

    def decoder_layers(self, tgt, ref, memory, shapes):
        for k in range(self.z["layers"]):
            p = f"decoder.decoder.layers.{k}"
            qp = self.mlp("decoder.query_pos_head", ref, 2)
            tgt = self.norm(p + ".norm1",
                            tgt + self.mha(p + ".self_attn", tgt + qp, tgt, self.z["d_heads"]))
            tgt = self.norm(p + ".norm2",
                            tgt + self.msda(p + ".cross_attn", tgt + qp, ref, memory, shapes))
            ffn = self.linear(p + ".linear2", torch.relu(self.linear(p + ".linear1", tgt)))
            tgt = self.norm(p + ".norm3", tgt + ffn)
            ref = torch.sigmoid(self.mlp(f"decoder.dec_bbox_head.{k}", tgt, 3) + inv_sigmoid(ref))
        last = self.z["layers"] - 1
        return tgt, self.linear(f"decoder.dec_score_head.{last}", tgt), ref

    def decode_at(self, memory, shapes, idx):
        """(last targets, logits, boxes) of the decoder from the tokens
        ``idx`` (B, Q)."""
        out, _, coord = self.selection_head(memory, shapes)
        tgt = torch.gather(out, 1, idx[..., None].expand(-1, -1, out.shape[-1]))
        ref = torch.sigmoid(torch.gather(coord, 1, idx[..., None].expand(-1, -1, 4)))
        return self.decoder_layers(tgt, ref, memory, shapes)

    def __call__(self, x_nhwc):
        """(memory, idx, logits, boxes, last targets) of a float32 NHWC batch."""
        feats = self.encoder(self.backbone(x_nhwc.float().permute(0, 3, 1, 2)))
        memory, shapes = self.memory(feats)
        _, score, _ = self.selection_head(memory, shapes)
        idx = torch.topk(score.max(-1).values, self.z["queries"], dim=1).indices
        tgt, logits, boxes = self.decode_at(memory, shapes, idx)
        return memory, idx, logits, boxes, tgt


def pos_table(h: int, w: int, dim: int) -> torch.Tensor:
    """(h * w, dim) float32: the source's ``build_2d_sincos_position_
    embedding(w, h, dim, 10000)``."""
    quarter = dim // 4
    omega = 1.0 / PE_TEMPERATURE ** (torch.arange(quarter, dtype=torch.float32) / quarter)
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                            torch.arange(h, dtype=torch.float32), indexing="ij")
    ow, oh = gw.flatten()[:, None] @ omega[None], gh.flatten()[:, None] @ omega[None]
    return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)


def priors(shapes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The source's ``_generate_anchors``: ((1, N, 4) logits with +inf at
    invalid tokens, (1, N, 1) bool valid)."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        xy = (torch.stack([gx, gy], -1).float() + 0.5) / torch.tensor([w, h]).float()
        wh = torch.ones_like(xy) * PRIOR_SIZE * 2.0 ** lvl
        out.append(torch.cat([xy, wh], -1).reshape(-1, h * w, 4))
    a = torch.cat(out, 1)
    valid = ((a > PRIOR_EPS) * (a < 1 - PRIOR_EPS)).all(-1, keepdim=True)
    a = torch.log(a / (1 - a))
    return torch.where(valid, a, torch.inf).to(device), valid.to(device)


def inv_sigmoid(x, eps: float = 1e-5):
    x = x.clip(min=0.0, max=1.0)
    return torch.log(x.clip(min=eps) / (1 - x).clip(min=eps))


def deform_core(value, shapes, loc, w) -> torch.Tensor:
    """The source's ``deformable_attention_core_func``: ``value`` (B, N,
    heads * d), ``loc`` (B, Q, heads, levels, points, 2), ``w`` (B, Q,
    heads, levels, points); (B, Q, heads * d)."""
    b, _, c = value.shape
    _, q, hd, lv, pt, _ = loc.shape
    d = c // hd
    values = value.split([h * w_ for h, w_ in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lvl, (h, w_) in enumerate(shapes):
        v = values[lvl].view(b, h * w_, hd, d).flatten(2).permute(0, 2, 1).reshape(b * hd, d, h, w_)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
    w = w.permute(0, 2, 1, 3, 4).reshape(b * hd, 1, q, lv * pt)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * w).sum(-1).reshape(b, hd * d, q)
    return out.permute(0, 2, 1)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _fold_bn(w, p: dict, suffix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    inv = p["gamma" + suffix] / torch.sqrt(p["var" + suffix] + BN_EPS)
    return w * inv[:, None, None, None], p["beta" + suffix] - p["mean" + suffix] * inv


def reparameterise(cfg: dict, tree: dict) -> dict:
    """The folded tree of an unfused one: each BN folded into its conv; a
    RepVGG block's 3x3 and 1x1 (zero-padded to 3x3) summed (the source's
    ``RepVggBlock.get_equivalent_kernel_bias``); the ``d`` shortcut keeps
    its pool before its folded 1x1; linear and norm leaves as they are."""
    out = {}
    for s in leaf_specs(cfg):
        p = tree[s["name"]]
        if s["kind"] in ("conv", "pooled", "rep"):
            w, b = _fold_bn(p["w"], p)
            if s["kind"] == "rep":
                w1, b1 = _fold_bn(p["w1x1"], p, "1x1")
                w, b = w + F.pad(w1, (1, 1, 1, 1)), b + b1
            out[s["name"]] = {"w": w, "b": b}
        else:
            out[s["name"]] = dict(p)
    return out


def unfused_forward(cfg: dict, tree: dict, x_nhwc, quant=None):
    """(memory, idx, logits, boxes) of the unfused tree."""
    return Net(cfg, tree, folded=False, quant=quant)(x_nhwc)[:4]


def folded_forward(cfg: dict, tree: dict, x_nhwc, quant=None):
    """(memory, idx, logits, boxes) of the folded tree."""
    return Net(cfg, tree, folded=True, quant=quant)(x_nhwc)[:4]


def decoder_from(cfg: dict, tree: dict, memory, idx, quant=None):
    """(logits, boxes) of the folded tree's decoder from ``memory`` (B, N,
    hidden) and the tokens ``idx`` (B, Q): the selection head's targets and
    references at ``idx``, then every decoder layer."""
    net = Net(cfg, tree, folded=True, quant=quant)
    _, logits, boxes = net.decode_at(memory, level_shapes(cfg, memory.shape[1]), idx)
    return logits, boxes


def level_shapes(cfg: dict, tokens: int) -> List[Tuple[int, int]]:
    """The levels' (h, w) of a square input whose memory has ``tokens``."""
    # N = S^2 (1/64 + 1/256 + 1/1024) for strides 8, 16, 32
    side = round(math.sqrt(tokens / (1 / 64 + 1 / 256 + 1 / 1024)))
    return [(side // s, side // s) for s in (8, 16, 32)]


def postprocess(logits, boxes, k: int, threshold: float, dtype=torch.float32):
    """((B, k, 6) float32 rows ``[cx, cy, w, h, score, class]`` by
    descending score, (B, k) bool kept): the top ``k`` of ``sig(logits)``
    over queries x classes, its arithmetic in ``dtype`` (bf16 for the
    control of what follows the forward)."""
    c = logits.shape[-1]
    score, i = torch.topk(torch.sigmoid(logits.to(dtype)).flatten(1), k, dim=1)
    box = torch.gather(boxes.to(dtype), 1, (i // c)[..., None].expand(-1, -1, 4))
    rows = torch.cat([box, score[..., None], (i % c)[..., None].to(dtype)], -1).float()
    return rows, score.float() >= threshold


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------


def conv_table(cfg: dict, size: int) -> List[dict]:
    """Every conv of the deploy form at a ``size`` x ``size`` input: its
    spec, output side, and operations per image (2 k^2 Cin Cout Ho Wo; a
    RepVGG block as its one 3x3; the ``d`` shortcut as its 1x1 on the pooled
    plane); ``skip`` where its epilogue reads a residual (a bottleneck's
    last conv, CSPRep's ``conv2``)."""
    z = sizes(cfg)
    sides = {}
    side = size // 2
    for name in ("conv1_1", "conv1_2", "conv1_3"):
        sides[f"backbone.conv1.{name}"] = side
    side //= 2
    for i, n in enumerate(z["depths"]):
        for j in range(n):
            p = f"backbone.res_layers.{i}.blocks.{j}"
            sides[p + ".branch2a"] = side
            if i > 0 and j == 0:
                side //= 2
            for k in ("branch2b", "branch2c", "short"):
                sides[f"{p}.{k}"] = side
    s3, s4, s5 = size // 8, size // 16, size // 32
    for i, s in enumerate((s3, s4, s5)):
        sides[f"encoder.input_proj.{i}"] = sides[f"decoder.input_proj.{i}"] = s
    sides["encoder.lateral_convs.0"], sides["encoder.lateral_convs.1"] = s5, s4
    sides["encoder.downsample_convs.0"], sides["encoder.downsample_convs.1"] = s4, s5
    for part, k, s in (("fpn_blocks", 0, s4), ("fpn_blocks", 1, s3), ("pan_blocks", 0, s4),
                       ("pan_blocks", 1, s5)):
        p = f"encoder.{part}.{k}"
        for name in ["conv1", "conv2"] + [f"bottlenecks.{j}" for j in range(z["blocks"])]:
            sides[f"{p}.{name}"] = s
    out = []
    for spec in leaf_specs(cfg):
        if spec["kind"] not in ("conv", "rep", "pooled"):
            continue
        s = sides[spec["name"]]
        skip = spec["name"].endswith((".branch2c", ".conv2")) and spec["name"].startswith(
            ("backbone.", "encoder.fpn", "encoder.pan"))
        out.append({**spec, "side_out": s, "skip": skip,
                    "flops": 2.0 * spec["k"] ** 2 * spec["cin"] * spec["cout"] * s * s})
    return out


def forward_flops(cfg: dict, size: int) -> float:
    """Operations of one image's forward, ``2 x MACs``: every conv of the
    deploy form (``conv_table``), every linear layer over its tokens, and
    the attention products (``QK^T`` and ``AV``: ``2 x 2 x L^2 x dim`` per
    attention); the bilinear sampling, softmaxes, norms and activations are
    left out."""
    z = sizes(cfg)
    h, q = z["hidden"], z["queries"]
    s5 = size // 32
    tokens = sum((size // s) ** 2 for s in (8, 16, 32))
    total = sum(c["flops"] for c in conv_table(cfg, size))

    def lin(cin, cout, n):
        return 2.0 * cin * cout * n

    # AIFI
    total += lin(h, 3 * h, s5 * s5) + 4.0 * (s5 * s5) ** 2 * h + lin(h, h, s5 * s5)
    total += lin(h, z["ffn"], s5 * s5) * 2
    # selection
    total += lin(h, h, tokens) + lin(h, z["classes"], tokens)
    total += lin(h, h, tokens) * 2 + lin(h, 4, tokens)
    hlp = z["d_heads"] * z["levels"] * z["points"]
    for _ in range(z["layers"]):
        total += lin(4, 2 * h, q) + lin(2 * h, h, q)  # query_pos_head
        total += lin(h, 3 * h, q) + 4.0 * q * q * h + lin(h, h, q)  # self-attention
        total += lin(h, h, tokens)  # value_proj
        total += lin(h, 3 * hlp, q) + lin(h, h, q)  # offsets, weights, output_proj
        total += lin(h, z["d_ffn"], q) * 2
        total += lin(h, h, q) * 2 + lin(h, 4, q)  # dec_bbox_head
    total += lin(h, z["classes"], q)
    return total


def param_count(cfg: dict) -> int:
    """Weights of the unfused network in its inference form (the
    published count: no BN statistics; a RepVGG block's two branches)."""
    n = 0
    for s in leaf_specs(cfg):
        if s["kind"] in ("conv", "pooled"):
            n += s["cout"] * (s["cin"] * s["k"] ** 2 + 2)
        elif s["kind"] == "rep":
            n += s["cout"] * (s["cin"] * 10 + 4)
        elif s["kind"] == "linear":
            n += s["cout"] * (s["cin"] + 1)
        else:
            n += 2 * s["n"]
    return n


def epilogue_bytes(cfg: dict, size: int, batch: int) -> float:
    """Bytes of every conv's epilogue at ``batch`` images: its output read and
    written once in bf16 (4 bytes an element), plus its skip read (2 bytes)
    where it has one."""
    return float(sum(batch * c["side_out"] ** 2 * c["cout"] * (6 if c["skip"] else 4)
                     for c in conv_table(cfg, size)))

