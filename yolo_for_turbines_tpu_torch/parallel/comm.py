"""Collectives of the parallel paths, their gradients, and the synced
batch norm.

Each helper takes a process group from a ``Mesh`` (``mesh.py``); a group of
None means one rank, and the helper does nothing. gloo refuses some
collectives on CUDA tensors, so over a gloo group a CUDA tensor is staged
through pinned host memory: copied out, reduced or gathered on the host,
copied back. That is the transport of a gloo group on every device (two
gloo ranks sharing one card, or CPU ranks), not a fallback: NCCL groups
take CUDA tensors as they are.

The gradients follow one rule: every collective's backward is its adjoint,
and the ranks' losses sum to the global loss. So the backward of an
all-reduce is an all-reduce, the backward of a row gather is a
reduce-scatter (an all-reduce and this rank's slice), and the gradient of a
replicated parameter is the sum over the ranks of their gradients
(``reduce_gradients``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
import torch.nn as nn


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (a gloo collective's staging)."""
    return t.detach().to("cpu").pin_memory()


def world_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_in(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no gradient); returns ``t``."""
    if group is None:
        return t
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``t`` with the group's first rank's copy (in place; no
    gradient)."""
    if group is None:
        return t
    src = 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)
    if _staged(t, group):
        h = _host(t)
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (every
    rank's ``t`` has the same shape; no gradient). Booleans travel as
    uint8."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    staged = _staged(src, group)
    src = _host(src) if staged else src.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(t.device)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def broadcast_module(module: nn.Module, group) -> None:
    """Overwrite every parameter and buffer of ``module`` with rank 0's (no
    gradient, no ``_version`` bump on the receiving ranks: the caller drops
    what it cached from the old weights)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` with a gradient: the backward sums the ranks'
    gradients (the adjoint of an all-reduce)."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_(grad.contiguous().clone(), ctx.group)
        i = rank_in(ctx.group)
        return total.narrow(ctx.dim, i * ctx.size, ctx.size), None, None


def gather_rows(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim``, on every rank.
    Its consumers run replicated, each rank's loss holding its share, so the
    backward sums the ranks' gradients and keeps this rank's slice (a
    reduce-scatter)."""
    if group is None:
        return t
    return _GatherRows.apply(t, group, dim)


def reduce_gradients(params: List[nn.Parameter], group) -> None:
    """Sum the parameters' gradients over ``group`` in place, in one flat
    all-reduce (a parameter with no gradient adds zeros)."""
    if group is None or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(p.dtype)
        offset += n


class _SyncBatchNormCUDA(torch.autograd.Function):
    """``sync_batch_norm`` on a CUDA tensor through ATen's fused batch-norm
    kernels (the ones ``nn.SyncBatchNorm`` runs): per-rank mean and inverse
    std in one Welford pass, the ranks' (mean, invstd, count) gathered, the
    global moments and the running statistics' update in one kernel, the
    normalisation in one; the backward reduces (sum dy, sum dy (x - mean))
    locally, all-reduces them (the adjoint of the moments' gather) and
    forms the input gradient in one kernel."""

    @staticmethod
    def forward(ctx, y, weight, bias, bn, group):
        c = y.shape[1]
        mean, invstd = torch.batch_norm_stats(y, bn.eps)
        count = mean.new_full((1,), float(y.numel() // c))
        stats = all_gather(torch.cat([mean, invstd, count])[None], group, dim=0)
        mean_all, invstd_all, count_all = stats.split([c, c, 1], dim=1)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            y, mean_all, invstd_all, bn.running_mean, bn.running_var, bn.momentum, bn.eps,
            count_all.view(-1))
        bn.num_batches_tracked.add_(1)
        ctx.save_for_backward(y, weight, mean, invstd, count_all.view(-1).to(torch.int32))
        ctx.group = group
        return torch.batch_norm_elemt(y, weight, bias, mean, invstd, bn.eps)

    @staticmethod
    def backward(ctx, g):
        y, weight, mean, invstd, counts = ctx.saved_tensors
        fmt = (torch.channels_last if y.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        g = g.contiguous(memory_format=fmt)
        sum_dy, sum_dy_xmu, grad_weight, grad_bias = torch.batch_norm_backward_reduce(
            g, y, mean, invstd, weight, True, True, True)
        c = y.shape[1]
        both = all_reduce_(torch.cat([sum_dy, sum_dy_xmu]), ctx.group)
        grad_input = torch.batch_norm_backward_elemt(
            g, y, mean, invstd, weight, both[:c], both[c:], counts)
        return grad_input, grad_weight, grad_bias, None, None


def sync_batch_norm(bn: nn.BatchNorm2d, y: torch.Tensor, group) -> torch.Tensor:
    """Train-mode batch norm of NCHW ``y`` with the moments of the global
    batch over ``group`` (every rank that holds other elements of the
    tensor); the running statistics update from the global moments, with
    the unbiased variance n / (n - 1) of the global count, on every rank
    alike. gloo and NCCL groups both take it; a group of None is a one-rank
    batch norm.

    On the CPU it is the JAX package's form (``bn_batch_moments``,
    ``bn_scale_shift``), differentiated by autograd: each rank's element
    count and its sums of ``y - shift`` and ``(y - shift)^2`` over (N, H,
    W), shifted by the running mean so that E[d^2] - E[d]^2 does not
    cancel, all-reduced with a gradient; ``y * inv + shift`` with the
    coefficients rounded to ``y``'s dtype. On CUDA the same moments come
    from ATen's fused batch-norm kernels (``_SyncBatchNormCUDA``): the
    elementwise form costs a dozen passes and as many launches per layer,
    which made the data-parallel train step 4x the plain one."""
    if y.is_cuda:
        return _SyncBatchNormCUDA.apply(y, bn.weight, bn.bias, bn, group)
    dtype = torch.promote_types(y.dtype, torch.float32)
    c = y.shape[1]
    n = y.numel() // c
    var_l, mean_l = torch.var_mean(y.to(dtype), dim=(0, 2, 3), correction=0)
    shift = bn.running_mean.detach().to(dtype)
    dm = mean_l - shift
    count_l = mean_l.new_full((1,), float(n))
    sums = all_reduce_sum(torch.cat([dm * n, (var_l + dm * dm) * n, count_l]), group)
    count = sums[-1].detach()
    dmean = sums[:c] / count
    var = torch.clamp(sums[c:2 * c] / count - dmean * dmean, min=0.0)
    mean = dmean + shift
    with torch.no_grad():
        m = bn.momentum
        unbiased = var.detach() * (count / torch.clamp(count - 1, min=1))
        bn.running_mean.mul_(1 - m).add_(m * mean.detach())
        bn.running_var.mul_(1 - m).add_(m * unbiased)
        bn.num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    b = bn.bias - mean * inv
    return torch.addcmul(b.to(y.dtype)[None, :, None, None], y,
                         inv.to(y.dtype)[None, :, None, None])
