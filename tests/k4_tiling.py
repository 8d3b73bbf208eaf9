"""A CPU emulation of how ``csrc/resblock_int8.cu`` (kernel K4) tiles one
quantized residual block, in plain torch and numpy integers.

It follows the kernel CTA by CTA: the zero-padded (W+2)-wide layout, tiles of
128 positions with their halo rows, the 1x1 split between the two CTAs of a
cluster (128 mid channels each) over a zero-filled x tile, the explicit zero
mask on ``mid``, ``mid`` as two 128-channel blocks of swizzled 128-byte rows,
K-major weights, the 3x3 as 18 K stages of 128 whose A operand starts at the
tap's row shift, and the residual box that the output codes overwrite in
place. Products are exact (each K stage in f32, summed in i32); the f32
epilogues use the plain version's torch ops in its order, so the result must
equal ``fused_residual_stage_int8_reference`` code for code.

Shared memory written by the kernel's threads is addressed with the kernel's
formula (``sw128_offset``); what the hardware reads or writes (wgmma operand
descriptors, TMA boxes) is addressed with the hardware's rule (``hw_swizzle``:
address bits 4-6 XOR bits 7-9), written independently of it.
"""

import numpy as np
import torch

from yolo_for_turbines_tpu_torch.ops.kernels import resblock_int8_kernel as rk
from yolo_for_turbines_tpu_torch.ops.kernels.resblock_kernel import _ACTIVATIONS

KM, KC, NOUT, HALF, TAPS = 128, 512, 256, 128, 9
ROW_BLOCKS = 3  # 64-row blocks of the 1x1
GARBAGE = 77    # what rows past a TMA box hold: anything


def sw128_offset(row, c):
    """The kernel's byte offset of (row, channel < 128) in a swizzled box."""
    return row * 128 + (((c >> 4) ^ row) & 7) * 16 + (c & 15)


def hw_swizzle(addr):
    """The 128-byte swizzle on an address relative to a 1024-aligned base."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _read_rows(block, row0, rows):
    """What wgmma reads through a descriptor that starts at row ``row0`` of a
    swizzled block: (rows, 128) s8."""
    addr = (row0 + np.arange(rows))[:, None] * 128 + np.arange(128)[None, :]
    return block[hw_swizzle(addr)]


def _requant(y):
    return torch.round(y).clamp_(-127, 127).to(torch.int8)


def _matmul(a, b):
    """Exact s8 (M, 128) @ (128, N) -> i32 as torch, one K stage: f32 holds
    |sum| <= 128 * 127^2 < 2^24."""
    assert a.shape[1] == 128
    a, b = torch.from_numpy(np.ascontiguousarray(a)), torch.from_numpy(np.ascontiguousarray(b))
    return (a.float() @ b.float()).to(torch.int32)


def emulate_block(xq, w1t, w2t, d1, b1, vm1, d2, b2, vout, rres, activation):
    """One block over xq (B, H, W, 512) s8 numpy; w1t (256, 512) and w2t
    (512, 2304) K-major s8 numpy; the rows f32 torch. Returns (B, H, W, 512)
    s8 numpy."""
    act = _ACTIVATIONS[activation]
    batch, h, w, c = xq.shape
    assert c == KC
    plan = rk.smem_plan(w)
    th, n1, wp = plan["th"], plan["n1"], w + 2
    assert n1 <= ROW_BLOCKS * 64
    x2d = xq.reshape(batch * h * w, c)
    out = np.zeros_like(xq)
    for img in range(batch):
        for y0 in range(0, h, th):
            # ---- the 1x1, one half of mid per CTA of the pair
            blocks = []
            for rank in range(2):
                p0 = (img * h + y0 - 1) * w
                rows = p0 + np.arange(ROW_BLOCKS * 64)
                xt = np.full((ROW_BLOCKS * 64, c), GARBAGE, np.int8)
                box = np.arange(ROW_BLOCKS * 64) < plan["xchunk"] // 128
                inside = box & (rows >= 0) & (rows < x2d.shape[0])
                xt[box] = 0  # TMA zero-fills rows outside the matrix
                xt[inside] = x2d[rows[inside]]
                acc = torch.zeros(ROW_BLOCKS * 64, HALF, dtype=torch.int32)
                for k in range(KC // 128):  # K stages
                    ks = slice(k * 128, (k + 1) * 128)
                    acc += _matmul(xt[:, ks], w1t[rank * HALF:(rank + 1) * HALF, ks].T)
                ch = slice(rank * HALF, (rank + 1) * HALF)
                codes = _requant(act(acc.float() * d1[ch] + b1[ch]) * vm1[ch]).numpy()
                block = np.zeros(plan["mid_block"], np.int8)
                p = np.arange(ROW_BLOCKS * 64)
                row = p // w
                y = y0 - 1 + row
                keep = (p < n1) & (y >= 0) & (y < h)  # mid stays 0 elsewhere
                mrow = 2 + row * wp + (p - row * w)
                off = sw128_offset(mrow[keep][:, None], np.arange(HALF)[None, :])
                assert off.max() < plan["mid_block"]
                block[off] = codes[keep]
                blocks.append(block)
            # ---- the exchange gives both CTAs both blocks; the 3x3 and the output
            for nh in range(2):
                rank = nh
                acc = torch.zeros(KM, NOUT, dtype=torch.int32)
                for k in range(2 * TAPS):
                    cb = rank if k < TAPS else rank ^ 1
                    tap = k % TAPS
                    row0 = 1 + wp + (tap // 3 - 1) * wp + (tap % 3 - 1)
                    assert row0 >= 0 and (row0 + KM) * 128 <= plan["mid_block"]
                    a = _read_rows(blocks[cb], row0, KM)
                    k0 = tap * 256 + cb * 128
                    acc += _matmul(a, w2t[nh * NOUT:(nh + 1) * NOUT, k0:k0 + 128].T)
                oc = slice(nh * NOUT, (nh + 1) * NOUT)
                yv = act(acc.float() * d2[oc] + b2[oc])
                # the residual tile as TMA writes it: two 128-channel boxes of
                # th * W rows, rows past the image zero-filled
                res = np.zeros(2 * plan["res_stride"], np.int8)
                tile = np.zeros((th, w, NOUT), np.int8)
                nrows = min(th, h - y0)
                tile[:nrows] = xq[img, y0:y0 + nrows, :, oc]
                box_addr = np.arange(th * w)[:, None] * 128 + np.arange(128)[None, :]
                for g in range(2):
                    res[g * plan["res_stride"] + hw_swizzle(box_addr)] = tile.reshape(
                        th * w, NOUT)[:, g * 128:(g + 1) * 128]
                q = np.arange(KM)
                ty = q // wp
                xc = q - ty * wp - 1
                valid = (ty < th) & (xc >= 0) & (xc < w)
                brow = (ty * w + xc)[valid]
                col = np.arange(NOUT)
                off = (col >> 7)[None, :] * plan["res_stride"] + sw128_offset(
                    brow[:, None], (col & 127)[None, :])
                xres = torch.from_numpy(res[off])
                codes = _requant(yv[torch.from_numpy(valid)] * vout[oc] + xres.float() * rres[oc])
                res[off] = codes.numpy()
                # the TMA store, clipped at the image's last row
                for g in range(2):
                    stored = res[g * plan["res_stride"] + hw_swizzle(box_addr)].reshape(th, w, 128)
                    out[img, y0:y0 + nrows, :, nh * NOUT + g * 128:nh * NOUT + (g + 1) * 128] = \
                        stored[:nrows]
    return out


def emulate_stage(xq, ops, activation):
    """A stack of blocks: ``ops`` from ``pack_int8_stage`` (torch), xq
    (B, H, W, 512) s8 torch. Returns s8 torch."""
    w1q, d1, b1, vm1, w2q, d2, b2, vout, rres = ops
    w1t, w2t = rk.kmajor_weights(w1q, w2q)
    x = xq.numpy()
    # many small ops: one thread is faster than a pool, most of all beside
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(w1q.shape[0]):
            x = emulate_block(x, w1t[i].numpy(), w2t[i].numpy(), d1[i], b1[i], vm1[i], d2[i],
                              b2[i], vout[i], rres[i], activation)
    finally:
        torch.set_num_threads(threads)
    return torch.from_numpy(x)
