"""Spatial partitioning (SP): image rows sharded over ranks, with explicit
halos (counterpart of ``yolo_for_turbines_tpu/parallel/spatial.py``).

The JAX package annotates the input ``P("data", "space")`` and lets GSPMD
derive every halo exchange. torch has no partitioner, so this module does
the partitioner's work by hand:

- a :class:`Layout` (``row_constraint``'s policy) decides, at each
  activation's global height, whether its rows stay sharded over the
  ``"space"`` axis (the height divides the axis and holds at least
  ``MIN_ROWS_PER_SHARD`` rows per shard) or are gathered, every rank then
  computing the tensor whole. It is applied where the JAX model calls
  ``constrain``: after every conv that changes the height, every pool, every
  upsample and concat;
- before a windowed op on a sharded tensor, :func:`halo` fetches the
  neighbours' boundary rows (an autograd Function: its backward returns the
  halo rows' gradients to their owners). A 3x3 stride-1 conv takes one row
  above and one below; a 3x3 stride-2 conv with the symmetric floor padding
  one row above (shard heights even); tiny's stride-1 2x2 SAME pool one row
  below, -inf for floats and the dtype's minimum for integer codes. The
  shards at the image's top and bottom edge pad as the unsharded op does;
- the heads are gathered (``comm.gather_rows``); loss, decode and NMS run
  replicated over ``"space"``;
- train-mode BN moments are all-reduced over data x space for a sharded
  tensor and over ``"data"`` for a gathered one (every space rank then holds
  the same rows).

The same ``Layout`` runs a data-parallel mesh (no space axis): no tensor is
ever row-sharded, and only BN, the loss counts and the gradients reduce.

The halos move (B, C, 1, W) rows through an all-gather of the space group,
so no rank waits on a point-to-point partner; over gloo a CUDA tensor is
staged through pinned host memory (``comm.py``).

The int8 forward (``models/quantize.py::apply_inference_int8``) takes the
same layout on its NHWC s8 codes: halos of codes (code 0 at the image's
edges) before each 3x3 int8 conv of its layer path, -128 for the SAME
pool.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.blocks import pool_valid
from . import comm
from .mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    Mesh,
    Sharding,
    _build,
    _world,
    batch_group,
    tree_map,
)

# Rows per shard below which an activation is gathered instead of staying
# row-sharded. Of the JAX package's two reasons (RESULTS.md, "Spatial
# partitioning") the numerical one (XLA's partitioner choosing a layout
# whose BN backward was wrong at 1-4 rows per shard) cannot recur with
# hand-written halos; the cost one stands: below 8 rows a 3x3 conv's halo
# is over 12% of the shard while the grid carries almost no work.
MIN_ROWS_PER_SHARD = 8


def create_spatial_mesh(n_space: Optional[int] = None, n_data: int = 1, device=None) -> Mesh:
    """2-D ``("data", "space")`` mesh: batch over ``n_data``, image rows over
    ``n_space`` (by default every remaining rank of the world); rank r sits
    at (r // n_space, r % n_space), so a space group is consecutive ranks.

    When ``n_data * n_space`` covers only part of the world, the first that
    many ranks form the mesh and the rest are idle (their mesh is not
    ``active``), which is warned about, as the JAX factory warns about idle
    devices."""
    world, _ = _world()
    if n_space is None:
        n_space = world // n_data
    n = n_data * n_space
    if world > n:
        warnings.warn(
            f"create_spatial_mesh(n_data={n_data}, n_space={n_space}) uses only the first "
            f"{n} of {world} ranks; the remaining {world - n} are idle", stacklevel=2)
    return _build((DATA_AXIS, SPACE_AXIS), (n_data, n_space), device, "create_spatial_mesh")


def spatial_image_sharding(mesh: Mesh) -> Sharding:
    """NHWC images: batch over ``"data"``, rows (H) over ``"space"``."""
    return Sharding({0: (mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS)),
                     1: (mesh.axis_index(SPACE_AXIS), mesh.axis_size(SPACE_AXIS))},
                    mesh.device)


def spatial_target_sharding(mesh: Mesh) -> Sharding:
    """(B, A, S, S, 6) target grids: batch axis only. The deepest grid's
    rows (13 at 416px) never divide a power-of-two space axis, and targets
    are a few KB per image: each space rank holds its data shard's whole
    grids, which the replicated loss reads."""
    return Sharding({0: (mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS))},
                    mesh.device)


def shard_spatial_batch(images, targets, mesh: Mesh):
    """(images, per-scale targets) as this rank's shards on its device."""
    img, tgt = spatial_image_sharding(mesh), spatial_target_sharding(mesh)
    return img.place(images), tree_map(tgt.place, targets)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _neighbours(parts, i: int, n: int, above: int, below: int, fill_like):
    """(top, bottom) of rank i from the gathered boundary rows: the rank
    above's last ``above`` rows and the rank below's first ``below`` rows,
    ``fill_like(rows)`` at the image's edges."""
    top = parts[i - 1][:, :, below:] if i > 0 else fill_like(above)
    bottom = parts[i + 1][:, :, :below] if i + 1 < n else fill_like(below)
    return top, bottom


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, fill, group):
        n, i = comm.world_of(group), comm.rank_in(group)
        h = x.shape[2]
        ctx.shape, ctx.group, ctx.rows = x.shape, group, (above, below)
        # what this rank's neighbours need: its first rows go up, its last
        # rows go down
        send = torch.cat([x[:, :, :below], x[:, :, h - above:]], dim=2)
        parts = comm.all_gather(send[None], group, dim=0)

        def fill_like(r):
            return x.new_full((*x.shape[:2], r, x.shape[3]), fill)

        top, bottom = _neighbours(parts, i, n, above, below, fill_like)
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        above, below = ctx.rows
        h = ctx.shape[2]
        n, i = comm.world_of(ctx.group), comm.rank_in(ctx.group)
        g_top, g_mid, g_bottom = g[:, :, :above], g[:, :, above:above + h], g[:, :, above + h:]
        # a halo row's gradient goes back to the rank that owns the row
        parts = comm.all_gather(torch.cat([g_bottom, g_top], dim=2)[None].contiguous(),
                                ctx.group, dim=0)
        gx = g_mid.clone()
        if i + 1 < n and above:  # rank i+1's top halo is this rank's last rows
            gx[:, :, h - above:] += parts[i + 1][:, :, below:]
        if i > 0 and below:  # rank i-1's bottom halo is this rank's first rows
            gx[:, :, :below] += parts[i - 1][:, :, :below]
        return gx, None, None, None, None


def halo(x: torch.Tensor, above: int, below: int, fill, group) -> torch.Tensor:
    """NCHW row shard ``x`` with ``above`` rows of the rank above and
    ``below`` rows of the rank below concatenated on (``fill`` at the
    image's edges). Its backward adds the halo rows' gradients into the
    rows they came from."""
    return _Halo.apply(x, above, below, fill, group)


# ---------------------------------------------------------------------------
# The layout policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rows:
    """How the activation a layer reads lies on the mesh: row-sharded over
    ``"space"`` or whole on every space rank. Convs, BN and pools of the
    models take it (``models/blocks.py``, ``models/yolov3.py``)."""

    layout: "Layout"
    sharded: bool

    def conv(self, x, weight, bias, stride: int, padding: int):
        """NCHW conv with the symmetric floor padding, on this layout."""
        k = weight.shape[2]
        if not self.sharded or k == 1:
            return F.conv2d(x, weight, bias, stride=stride, padding=padding)
        if (k, padding) != (3, 1) or stride not in (1, 2):
            raise ValueError(f"no halo rule for a {k}x{k} stride-{stride} conv")
        # stride 1 reads a row on either side; stride 2 (even shard
        # heights, so every shard starts on an even row) reads the row above
        # its first output's window and nothing below
        x = halo(x, 1, 1 if stride == 1 else 0, 0.0, self.layout.space_group)
        return F.conv2d(x, weight, bias, stride=stride, padding=(0, 1))

    def bn(self, bn, y):
        """``bn`` in eval mode as is; in train mode with the moments of
        every rank that holds other elements of the tensor."""
        if not bn.training:
            return bn(y)
        group = self.layout.mesh.group if self.sharded else self.layout.batch_group
        return comm.sync_batch_norm(bn, y, group)

    def pool(self, x, kernel: int, stride: int):
        """The JAX ``maxpool2d`` (VALID for stride > 1, SAME for stride 1:
        (k - 1) // 2 rows and columns before, the rest after)."""
        if stride != 1:
            return pool_valid(x, kernel, stride)
        before, after = (kernel - 1) // 2, kernel - 1 - (kernel - 1) // 2
        fill = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
        if self.sharded:
            x = halo(x, before, after, fill, self.layout.space_group)
        else:
            x = F.pad(x, (0, 0, before, after), value=fill)
        return pool_valid(F.pad(x, (before, after, 0, 0), value=fill), kernel, 1)


class Layout:
    """The row layout policy of a mesh (``row_constraint``'s port), and the
    reductions a step on it needs.

    An activation of global height h is row-sharded iff the mesh has a
    space axis of n > 1 ranks, h % n == 0 and h >= ``min_rows`` * n; any
    other is gathered. On a data-parallel mesh nothing is sharded."""

    def __init__(self, mesh: Mesh, min_rows: int = MIN_ROWS_PER_SHARD):
        if not mesh.active:
            raise ValueError(f"rank {mesh.rank} is idle on this mesh of {mesh.size} ranks")
        self.mesh = mesh
        self.min_rows = min_rows
        self.n_space = mesh.axis_size(SPACE_AXIS)
        self.space_group = mesh.axis_groups.get(SPACE_AXIS)
        self.batch_group = batch_group(mesh)

    def shards(self, h: int) -> bool:
        n = self.n_space
        return n > 1 and h % n == 0 and h >= self.min_rows * n

    def spec(self, shape) -> Tuple[str, ...]:
        """The JAX PartitionSpec (trailing Nones stripped) this policy gives
        an NHWC activation of global ``shape``."""
        return (DATA_AXIS, SPACE_AXIS) if self.shards(shape[1]) else (DATA_AXIS,)

    def enter(self, x):
        """The rank's NCHW input shard (rows sharded when a space axis
        exists), constrained."""
        return self.constrain(x, Rows(self, self.n_space > 1))

    def constrain(self, x, rows: Rows):
        """``x`` re-laid to the policy's decision at its global height:
        gathered, or sliced to this rank's rows."""
        h = x.shape[2] * (self.n_space if rows.sharded else 1)
        want = self.shards(h)
        if rows.sharded and not want:
            return self.gather(x, rows), Rows(self, False)
        if want and not rows.sharded:
            i, step = self.mesh.axis_index(SPACE_AXIS), h // self.n_space
            return x[:, :, i * step:(i + 1) * step], Rows(self, True)
        return x, rows

    def fit(self, x, rows: Rows, stride: int):
        """Before a strided window: a shard whose height the stride does not
        divide is gathered (the output's height then cannot shard either)."""
        if rows.sharded and x.shape[2] % stride:
            return self.gather(x, rows), Rows(self, False)
        return x, rows

    def gather(self, x, rows: Rows):
        """The whole rows of ``x`` on every space rank."""
        if not rows.sharded:
            return x
        return comm.gather_rows(x.contiguous(), self.space_group, dim=2)

    # -- a step's reductions ---------------------------------------------

    @property
    def loss_weight(self) -> float:
        """Each space rank holds its data shard's whole loss: its share of
        the global loss is 1 / n_space of it."""
        return 1.0 / self.n_space

    def reduce_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """The loss's element counts over the global batch (no gradient)."""
        return comm.all_reduce_(counts.detach().clone(), self.batch_group)

    def reduce_metrics(self, metrics: dict) -> dict:
        """Each rank's share of the global loss terms, summed: the global
        terms on every rank (no gradient)."""
        keys = list(metrics)
        flat = comm.all_reduce_(torch.stack([metrics[k].detach().float() for k in keys]),
                                self.batch_group)
        return dict(zip(keys, flat.unbind()))

    def reduce_gradients(self, params) -> None:
        comm.reduce_gradients(list(params), self.mesh.group)


def row_constraint(mesh: Mesh, min_rows: int = MIN_ROWS_PER_SHARD) -> Optional[Layout]:
    """The row layout policy of a spatial mesh; None when ``mesh`` has no
    space axis of more than one rank (as the JAX function)."""
    if mesh.axis_size(SPACE_AXIS) == 1:
        return None
    return Layout(mesh, min_rows)


def is_spatial(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and SPACE_AXIS in mesh.axis_names

