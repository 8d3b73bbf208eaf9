"""CPU emulations of how ``csrc/nms.cu`` (kernel K1) and ``csrc/iou.cu``
(kernel K3) arrange their work, in plain torch and Python integers.

Both kernels share ``csrc/boxes.cuh``: a box is converted once (top-left
corner, far corner ``x1 + w``, ``area = w * h``) and the IoU of a pair is
computed from those, in the plain versions' operation order.
``boxes_once`` / ``iou_from`` repeat that in torch f32, op for op.

K1 (``emulate_greedy_nms``) follows the kernel: the suppress bits as
K x ceil(K/32) words of 32 bits, computed only for the tasks (word column w,
32-row chunk rc <= w) at or above the diagonal and left as garbage
elsewhere; keep words that start as the validity bits; a sweep that, word
by word, visits only the set bits of the current word in order (``ffs``),
clears the visited row's words from the keep words at or right of the
current one, and drops from the pending bits those the row cleared. It must
equal ``greedy_nms_reference`` mask for mask.
"""

import torch

GARBAGE = 0xDEADBEEF  # what a word no task wrote holds: anything


def boxes_once(boxes4: torch.Tensor, box_format: str):
    """(..., 4) f32 -> (x1, y1, x2, y2, area), each computed once per box."""
    a, b, w, h = boxes4.float().unbind(-1)
    if box_format == "center":
        a, b = a - w / 2, b - h / 2
    return a, b, a + w, b + h, w * h


def iou_from(row, col):
    """IoU of row boxes against column boxes from ``boxes_once`` tuples
    (broadcast), in the kernels' order."""
    x1i, y1i, x2i, y2i, ai = row
    x1j, y1j, x2j, y2j, aj = col
    xa, ya = torch.maximum(x1i, x1j), torch.maximum(y1i, y1j)
    xb, yb = torch.minimum(x2i, x2j), torch.minimum(y2i, y2j)
    zero = torch.zeros((), dtype=torch.float32)
    inter = torch.maximum(xb - xa, zero) * torch.maximum(yb - ya, zero)
    return inter / (ai + aj - inter + 1e-6)


def pairwise_iou_once(boxes4: torch.Tensor, box_format: str) -> torch.Tensor:
    """K3's arithmetic: (K, 4) -> (K, K), per-box values computed once."""
    b = boxes_once(boxes4, box_format)
    return iou_from(tuple(t[:, None] for t in b), tuple(t[None, :] for t in b))


def suppress_words(cand: torch.Tensor, thr: float, box_format: str):
    """One image's (K, 6) candidates -> K x ceil(K/32) Python ints: word w of
    row i has bit b set when j = 32 w + b > i, same class, IoU(i, j) >= thr.
    Only the tasks (w, rc <= w) are computed."""
    k = cand.shape[0]
    words = (k + 31) // 32
    box = boxes_once(cand[:, :4], box_format)
    cls = cand[:, 5].float()
    bits = [[GARBAGE] * words for _ in range(k)]
    for w in range(words):
        js = torch.arange(32 * w, min(32 * w + 32, k))
        col = tuple(t[js][None, :] for t in box)
        for rc in range(w + 1):
            rows = torch.arange(32 * rc, min(32 * rc + 32, k))
            iou = iou_from(tuple(t[rows][:, None] for t in box), col)
            s = (js[None, :] > rows[:, None]) & (cls[rows][:, None] == cls[js][None, :]) \
                & (iou >= thr)
            for r, i in enumerate(rows.tolist()):
                bits[i][w] = sum(1 << b for b in torch.nonzero(s[r]).flatten().tolist())
    return bits


def sweep(bits, valid_row) -> list:
    """The warp's sweep over one image; returns the final keep words. Each
    visited bit stays set, so the dependent steps number the kept boxes."""
    k = len(valid_row)
    words = (k + 31) // 32
    keep = [sum(1 << b for b in range(32) if 32 * w + b < k and valid_row[32 * w + b])
            for w in range(words)]
    for w in range(words):
        pending = keep[w]
        while pending:
            b = (pending & -pending).bit_length() - 1  # ffs
            row = bits[32 * w + b]
            for lw in range(w, words):  # words left of w are final and not read
                keep[lw] &= ~row[lw]
            pending &= ~row[w] & ~((2 << b) - 1)
    return keep


def emulate_greedy_nms(cand: torch.Tensor, valid: torch.Tensor, thr: float,
                       box_format: str = "center") -> torch.Tensor:
    """(B, K, 6), (B, K) bool -> (B, K) bool keep mask, the kernel's way."""
    b, k = valid.shape
    out = torch.zeros(b, k, dtype=torch.bool)
    for n in range(b):
        keep = sweep(suppress_words(cand[n], thr, box_format), valid[n].tolist())
        for j in range(k):
            out[n, j] = bool((keep[j >> 5] >> (j & 31)) & 1)
    return out
