"""Weights from ``--seed``, made on the device in a few large draws.

Both sides of a cell get the same numbers: the program through its own
loading entry, the reference as the tree it reads.

- :func:`folded` (serving): each conv's weight drawn U(-1/sqrt(fan_in),
  1/sqrt(fan_in)); a BN conv is then calibrated on a few images of the
  cell's own traffic the way a trained network's folded BN would be,
  normalising each output channel over those images and applying a scale
  U(0.5, 1.5) and a shift N(0, 1), the scale of a residual block's second
  conv times ``BRANCH_GAIN``, so that every layer carries signal and the
  heads are no mere biases; each objectness row of a head's last 1x1 is
  scaled and shifted so that its logits on those images have mean
  ``OBJECTNESS_MEAN`` and standard deviation ``OBJECTNESS_STD``, which puts
  a few dozen candidates per image above the 0.5 score threshold.

  Why the branch gain and the shift: with every layer at unit gain and
  shifts near 0 the 75-layer network is chaotic, and bf16 rounding grows to
  0.16-0.30 (relative RMS) at the heads of the leaky model, in the
  reference alone; with the residual branches at a tenth of the trunk (as
  in a trained Darknet, whose blocks refine rather than replace) and shifts
  that move most pre-activations off the activation's kink, it stays at
  0.03-0.05, so that the comparison with the reference can tell rounding
  from a fault.
- :func:`trainable` (training): the same weight draw, BN scale 1, shift 0,
  running mean 0 and variance 1 (a fresh network), a residual block's second
  BN scale at ``BRANCH_GAIN`` (small-init residuals, as the zero-initialised
  last BN of each block in Goyal et al., arXiv:1706.02677, section 5.1), and
  a head's last 1x1 bias drawn like its weights. With every scale at 1 the
  fresh network is as chaotic as above: bf16 autocast's first-step loss lay
  0.01-0.16 from float32's, as far as float8's; with the small branches,
  0.02 against float8's 0.09 (B=4, on the CPU).
"""

from __future__ import annotations

import torch

from .reference import model as ref

OBJECTNESS_MEAN, OBJECTNESS_STD = -4.0, 1.5
BRANCH_GAIN = 0.1
SHIFT_STD = 1.0


def _draws(specs, gen, device):
    """One uniform weight per conv in (-bound, bound), cut from one draw."""
    sizes = [s["cout"] * s["cin"] * s["k"] ** 2 for s in specs]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, at = [], 0
    for s, n in zip(specs, sizes):
        w = flat[at : at + n].view(s["cout"], s["cin"], s["k"], s["k"])
        out.append(w * ref.uniform_bound(s["cin"], s["k"]))
        at += n
    return out


def _tree(plan):
    """Empty weight tree aligned with ``plan``: a dict per conv entry, a list
    of block dicts per residual stage, a dict per head, {} per upsample."""
    tree = []
    for e in plan:
        if e["kind"] == "conv":
            tree.append({"conv": {}})
        elif e["kind"] == "res":
            tree.append([{"conv1": {}, "conv2": {}} for _ in range(e["n"])])
        elif e["kind"] == "head":
            tree.append({"conv1": {}, "conv2": {}})
        else:
            tree.append({})
    return tree


@torch.no_grad()
def folded(cfg: dict, seed: int, images: torch.Tensor):
    """The folded tree (``{"w": OIHW, "b"}`` per conv, float32 on the images'
    device), calibrated on ``images`` (N, S, S, 3) in [0, 1]."""
    device = images.device
    plan = ref.parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    specs = ref.conv_specs(plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = {s["path"]: w for s, w in zip(specs, _draws(specs, gen, device))}
    channels = sum(s["cout"] for s in specs)
    gamma = torch.rand(channels, generator=gen, device=device) + 0.5
    beta = SHIFT_STD * torch.randn(channels, generator=gen, device=device)
    head_bias = torch.rand(channels, generator=gen, device=device) * 2 - 1
    spec_of = {s["path"]: s for s in specs}
    offsets, at = {}, 0
    for s in specs:
        offsets[s["path"]] = at
        at += s["cout"]
    tree = _tree(plan)
    act = ref.activation(cfg["activation"])
    c5 = cfg["num_classes"] + 5

    def conv_act(path, x, stride, use_act):
        spec = spec_of[path]
        w = weights[path]
        at = offsets[path]
        node = ref.leaf(tree, path)
        if spec["bn"]:
            y = torch.nn.functional.conv2d(x, w, stride=stride, padding=spec["k"] // 2)
            mean, std = y.mean(dim=(0, 2, 3)), y.std(dim=(0, 2, 3)).clamp(min=1e-6)
            g = gamma[at : at + spec["cout"]] / std
            if len(path) == 3 and path[2] == "conv2" and plan[path[0]]["residual"]:
                g = g * BRANCH_GAIN
            node["w"] = w * g[:, None, None, None]
            node["b"] = beta[at : at + spec["cout"]] - mean * g
        else:
            b = head_bias[at : at + spec["cout"]] * ref.uniform_bound(spec["cin"], spec["k"])
            w, b = w.clone(), b.clone()
            free = torch.nn.functional.conv2d(x, w)
            for a in range(spec["cout"] // c5):
                row = a * c5 + 4
                gain = OBJECTNESS_STD / free[:, row].std()
                w[row] *= gain
                b[row] = OBJECTNESS_MEAN - gain * free[:, row].mean()
            node["w"], node["b"] = w, b
        y = torch.nn.functional.conv2d(x, node["w"], node["b"], stride=stride,
                                       padding=spec["k"] // 2)
        return act(y) if use_act else y

    with ref.exact_f32():
        ref._walk(plan, images.float().permute(0, 3, 1, 2), conv_act, lambda e, y: y)
    return plan, tree


@torch.no_grad()
def trainable(cfg: dict, seed: int, device):
    """The trainable tree (``w``, ``gamma``, ``beta``, ``mean``, ``var`` per BN
    conv; ``w``, ``b`` for a head's last 1x1), float32 on ``device``."""
    plan = ref.parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    specs = ref.conv_specs(plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = _tree(plan)
    for s, w in zip(specs, _draws(specs, gen, device)):
        node = ref.leaf(tree, s["path"])
        node["w"] = w.clone()
        if s["bn"]:
            branch = len(s["path"]) == 3 and s["path"][2] == "conv2" \
                and plan[s["path"][0]]["residual"]
            node["gamma"] = torch.full((s["cout"],), BRANCH_GAIN if branch else 1.0,
                                       device=device)
            node["beta"] = torch.zeros(s["cout"], device=device)
            node["mean"] = torch.zeros(s["cout"], device=device)
            node["var"] = torch.ones(s["cout"], device=device)
        else:
            bound = ref.uniform_bound(s["cin"], s["k"])
            node["b"] = (torch.rand(s["cout"], generator=gen, device=device) * 2 - 1) * bound
    return plan, tree

