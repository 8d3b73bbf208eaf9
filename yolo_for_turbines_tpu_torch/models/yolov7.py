"""YOLOv7's blocks (Wang, Bochkovskiy and Liao, arXiv:2207.02696): E-ELAN,
MP down-sampling and SPPCSPC, as plan entries and as modules over either
conv (the trainable ``ConvBlock`` or the folded ``FoldedConv``), in the
manner of ``models/cspdarknet.py``. ``models/yolov3.py`` builds them from
the layer list (``YOLOV7_LAYER_CONFIG``), walks them and gives YOLOv7's
head (``PlanRepHead``). Every conv is ``Conv(c, k, s)``: a conv with padding
k // 2, BN folded into a bias on the folded side, then SiLU.

- ``PlanELAN`` (``["elan", mid, q, out]`` in the backbone, ``["elanh", mid,
  q, out]`` in the neck): ``a = Conv1x1(x, mid)``, ``b = Conv1x1(x, mid)``, a
  chain of four 3x3 convs to ``q`` from ``b``, and a 1x1 to ``out`` on the
  concat of the chain outputs that ``picks`` names (deepest first), then
  ``b`` and ``a``: ``(4, 2)`` for ELAN, ``(4, 3, 2, 1)`` for ELAN-H;
- ``PlanMP`` (``["mp", c]``, ``["mp", c, route]``): ``[Conv3x3s2(Conv1x1(x,
  c), c), Conv1x1(maxpool2x2s2(x), c)]``, and the saved route ``route`` as a
  third part when one is named;
- ``PlanSPPCSPC`` (``["sppcspc", c]``): the 5, 9 and 13 SAME pools inside a
  CSP split, seven convs ``cv1`` ... ``cv7``, the pools' pyramid and a
  concat, in the order of YOLOv7's ``common.py::SPPCSPC``: ``cat[x1,
  pool5(x1), pool9(x1), pool13(x1)]``, one ``blocks.maxpool_pyramid``.

The weight tree of each holds its convs by their names in the module
(``a``, ``b``, ``chain[j]``, ``fuse``; ``pool``, ``reduce``, ``down``;
``cv1`` ... ``cv7``), which ``conv_paths`` reads.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch.nn as nn

from .blocks import ChannelConcat, FoldedConv, maxpool2d, maxpool_pyramid

# which chain outputs each ELAN form's concat joins, deepest first (1-4;
# 0 would be b, which always joins after them)
ELAN_PICKS = {"elan": (4, 2), "elanh": (4, 3, 2, 1)}
SPP_POOLS = (5, 9, 13)


@dataclasses.dataclass(frozen=True)
class PlanELAN:
    in_ch: int
    mid: int
    q: int
    out_ch: int
    picks: Tuple[int, ...]
    family: ClassVar[str] = "YOLOv7"
    label: ClassVar[str] = "ELAN"

    @property
    def cat_ch(self) -> int:
        return len(self.picks) * self.q + 2 * self.mid


@dataclasses.dataclass(frozen=True)
class PlanMP:
    in_ch: int
    out_ch: int  # each conv branch's width
    route: Optional[str] = None
    family: ClassVar[str] = "YOLOv7"
    label: ClassVar[str] = "MP"


@dataclasses.dataclass(frozen=True)
class PlanSPPCSPC:
    in_ch: int
    out_ch: int
    family: ClassVar[str] = "YOLOv7"
    label: ClassVar[str] = "SPPCSPC"


class ELAN(nn.Module):
    """An ELAN or ELAN-H block of ``conv(in_ch, out_ch, kernel)``s, made and
    registered in the order a, b, the chain, fuse."""

    def __init__(self, entry: PlanELAN, conv):
        super().__init__()
        self.entry = entry
        self.a = conv(entry.in_ch, entry.mid, 1)
        self.b = conv(entry.in_ch, entry.mid, 1)
        self.chain = nn.ModuleList(conv(entry.mid if j == 0 else entry.q, entry.q, 3)
                                   for j in range(4))
        self.fuse = conv(entry.cat_ch, entry.out_ch, 1)

    def forward(self, x, act):
        """The concat ``[picked chain outputs, b, a]`` is written in place
        where ``blocks.ChannelConcat`` can; ``b`` and the picked chain
        outputs that the next chain conv reads are kept as tensors too."""
        e = self.entry
        slot = {p: i for i, p in enumerate(e.picks)}  # chain output -> part
        n = len(e.picks)
        cat = ChannelConcat(x, act, (e.q,) * n + (e.mid, e.mid), x.shape[2:],
                            isinstance(self.fuse, FoldedConv))
        cat.conv(n + 1, self.a, x, act)
        y = cat.conv(n, self.b, x, act, keep=True)
        for j, c in enumerate(self.chain, 1):
            keep = j < len(self.chain)
            y = cat.conv(slot[j], c, y, act, keep=keep) if j in slot else c(y, act)
        return self.fuse(cat.result(), act)


class MPDown(nn.Module):
    """MP down-sampling: ``pool`` (the 1x1 after the max pool), ``reduce``
    and ``down`` (the stride-2 3x3), in YOLOv7's order."""

    def __init__(self, entry: PlanMP, conv):
        super().__init__()
        self.width = entry.out_ch
        self.pool = conv(entry.in_ch, entry.out_ch, 1)
        self.reduce = conv(entry.in_ch, entry.out_ch, 1)
        self.down = conv(entry.out_ch, entry.out_ch, 3, 2)

    def forward(self, x, act, route=None):
        """``[down, pool]`` (and ``route``), written in place where
        ``blocks.ChannelConcat`` can; the route, which later layers read
        too, is copied in."""
        c = self.width
        widths = (c, c) if route is None else (c, c, route.shape[1])
        size = tuple((n - 1) // 2 + 1 for n in x.shape[2:])  # the stride-2 3x3's
        cat = ChannelConcat(x, act, widths, size, isinstance(self.down, FoldedConv))
        cat.conv(0, self.down, self.reduce(x, act), act)
        cat.conv(1, self.pool, maxpool2d(x, 2, 2), act)
        if route is not None:
            cat.put(2, route)
        return cat.result()


class SPPCSPC(nn.Module):
    """SPPCSPC at ``c_ = out_ch``: ``cv1`` ... ``cv7`` registered in order."""

    def __init__(self, entry: PlanSPPCSPC, conv):
        super().__init__()
        cin, c = entry.in_ch, entry.out_ch
        self.width = c
        self.cv1 = conv(cin, c, 1)
        self.cv2 = conv(cin, c, 1)
        self.cv3 = conv(c, c, 3)
        self.cv4 = conv(c, c, 1)
        self.cv5 = conv(4 * c, c, 1)
        self.cv6 = conv(c, c, 3)
        self.cv7 = conv(2 * c, c, 1)

    def forward(self, x, act):
        """``cv7`` reads ``[y1, cv2]``, written in place where
        ``blocks.ChannelConcat`` can."""
        c = self.width
        cat = ChannelConcat(x, act, (c, c), x.shape[2:], isinstance(self.cv7, FoldedConv))
        x1 = self.cv4(self.cv3(self.cv1(x, act), act), act)
        pooled = maxpool_pyramid(x1, (1,) + SPP_POOLS)
        cat.conv(0, self.cv6, self.cv5(pooled, act), act)
        cat.conv(1, self.cv2, x, act)
        return self.cv7(cat.result(), act)
