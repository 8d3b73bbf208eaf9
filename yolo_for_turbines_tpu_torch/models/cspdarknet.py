"""CSPDarknet-53: the Darknet-53 skeleton with Cross-Stage-Partial stages
(counterpart of ``yolo_for_turbines_tpu/models/cspdarknet.py``).

A CSP stage projects its input into two 1x1 branches: one (``split2``)
runs a stack of residual blocks and a 1x1 ``transition``, the other
(``split1``) is the shortcut; ``fuse`` (1x1) takes the concat
``[transition output, shortcut]`` back to the stage's width. The neck and
heads are Darknet-53's, and routes are saved at the two 8-block stages.

Two modules over a ``PlanCSP``, with the JAX tree's names
(``split1``, ``split2``, ``blocks[i].conv1`` / ``conv2``, ``transition``,
``fuse``): ``TrainableCSPStage`` (conv + BN) and ``CSPStage`` (folded).
"""

from __future__ import annotations

import dataclasses

import torch.nn as nn

from .blocks import ChannelConcat, ConvBlock, FoldedConv, residual_blocks


@dataclasses.dataclass(frozen=True)
class PlanCSP:
    """One CSP stage at ``channels`` (its input and output width).

    ``first_stage=True`` keeps full-width branches (YOLOv4's first stage);
    later stages use half-width ones."""

    channels: int
    num_blocks: int
    save_route: bool = False
    first_stage: bool = False

    @property
    def branch_ch(self) -> int:
        return self.channels if self.first_stage else self.channels // 2

    @property
    def hidden_ch(self) -> int:
        return self.channels // 2


# Darknet-53's downsample skeleton with ("C", n) CSP stages in place of its
# ("B", n) residual stacks; the neck and head entries are unchanged.
CSP_LAYER_CONFIG = (
    (32, 3, 1),
    (64, 3, 2),
    ("C", 1),
    (128, 3, 2),
    ("C", 2),
    (256, 3, 2),
    ("C", 8),  # route to detection head
    (512, 3, 2),
    ("C", 8),  # route to detection head
    (1024, 3, 2),
    ("C", 4),
    (512, 1, 1),
    (1024, 3, 1),
    "S",
    (256, 1, 1),
    "U",
    (256, 1, 1),
    (512, 3, 1),
    "S",
    (128, 1, 1),
    "U",
    (128, 1, 1),
    (256, 3, 1),
    "S",
)

# the stage's convs outside its blocks, all 1x1
SINGLE_CONVS = ("split1", "split2", "transition", "fuse")


def conv_shapes(entry: PlanCSP) -> dict:
    """{name: (in_ch, out_ch, kernel)} of each single conv, and
    ``"conv1"`` / ``"conv2"`` of every block."""
    c, bc, hc = entry.channels, entry.branch_ch, entry.hidden_ch
    return {"split1": (c, bc, 1), "split2": (c, bc, 1), "transition": (bc, bc, 1),
            "fuse": (2 * bc, c, 1), "conv1": (bc, hc, 1), "conv2": (hc, bc, 3)}


class _Stage(nn.Module):
    """A CSP stage's convs, each ``conv(in_ch, out_ch, kernel)``, made and
    registered in the order split1, split2, the blocks, transition, fuse;
    the forward is ``apply_csp_entry``'s."""

    def __init__(self, entry: PlanCSP, conv):
        super().__init__()
        self.entry = entry
        shapes = conv_shapes(entry)
        self.split1 = conv(*shapes["split1"])
        self.split2 = conv(*shapes["split2"])
        self.blocks = residual_blocks(entry.branch_ch, entry.hidden_ch, entry.num_blocks, conv)
        self.transition = conv(*shapes["transition"])
        self.fuse = conv(*shapes["fuse"])

    def forward(self, x, act, rows=None):
        """The concat ``[transition, split1]`` is written in place where
        ``blocks.ChannelConcat`` can (both parts are the stage's own convs'
        results, which nothing else reads)."""
        bc = self.entry.branch_ch
        folded = isinstance(self.fuse, FoldedConv)
        cat = ChannelConcat(x, act, (bc, bc), x.shape[2:], folded, rows)
        cat.conv(1, self.split1, x, act, rows=rows)
        y = self.split2(x, act, rows)
        for blk in self.blocks:
            y = blk["conv2"](blk["conv1"](y, act, rows), act, rows, skip=y)
        cat.conv(0, self.transition, y, act, rows=rows)
        return self.fuse(cat.result(), act, rows)


class TrainableCSPStage(_Stage):
    """A CSP stage of ``ConvBlock``s (conv + BN + activation); weights drawn
    from ``generator`` in the order split1, split2, the blocks, transition,
    fuse."""

    def __init__(self, entry: PlanCSP, generator=None):
        super().__init__(entry, lambda *shape: ConvBlock(*shape, generator=generator))


class CSPStage(_Stage):
    """A CSP stage over BN-folded weights (conv + bias + activation)."""

    def __init__(self, entry: PlanCSP):
        super().__init__(entry, FoldedConv)
