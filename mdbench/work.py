"""Operations and bytes of the port's kernels from their shapes, and the
card's peaks: the yardstick of the roofline and mfu metrics.

Each input is read once and each output written once; operations are
counted per output point. The arithmetic is a copy of ``chip_smoke.py``'s
``bound``, ``sweep_corr_work``, ``sweep_warp_work`` and
``image_warp_work``, frozen here so that a change to the program cannot
move the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores: the kernels' arithmetic
BF16_FLOPS = 989e12  # bf16 tensor cores: the models' convolutions


def bound_ms(nbytes, flops):
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flops`` float32 operations, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def sweep_corr_work(b, r, w, c, d, h, g, esize):
    """src (B,R,W,C), ref (B,H,W,C), sx/sy (B,D,H,W) f32 -> (B,D,H,W,G):
    four taps of C multiply-adds, the product with ref, the group mean and
    ~8 operations of tap weights per point. (bytes, operations)"""
    pts = b * d * h * w
    return (b * (r + h) * w * c * esize + 2 * pts * 4 + pts * g * esize,
            pts * (8 * c + c + c + g + 8))


def sweep_warp_work(b, r, w, c, d, h, esize, backward=False):
    """Forward: src, coordinates -> (B,D,H,W,C). Backward: the (B,D,H,W,C)
    gradient and the coordinates -> dsrc (B,R,W,C)."""
    pts = b * d * h * w
    nbytes = b * r * w * c * esize + 2 * pts * 4 + pts * c * esize
    return nbytes, pts * (8 * c + (0 if backward else 8))


def image_warp_work(b, k, h, w, c, backward=False, l1=False):
    """Forward: images (B,H,W,C), coordinates -> (B,K,H,W,C) [+ target in,
    L1 (B,K,H,W) out]. Backward: images, coordinates, gradient [+ target,
    L1 gradient] -> dsx, dsy."""
    pts = b * k * h * w
    img = b * h * w * c * 4
    if backward:
        nbytes = img + 2 * pts * 4 + pts * c * 4 + 2 * pts * 4
        flops = pts * (14 * c + 4)
        if l1:
            nbytes += img + pts * 4
            flops += pts * (12 * c + 1)
    else:
        nbytes = img + 2 * pts * 4 + pts * c * 4
        flops = pts * (8 * c + 8)
        if l1:
            nbytes += img + pts * 4
            flops += pts * (3 * c + 1)
    return nbytes, flops


def mvs_shape(cfg, batch):
    """The cost volume's shapes at a batch: B, the source rows R and
    width W, FPN channels C, bins D, reference rows H, groups G."""
    s = 2 ** cfg.prior_scale
    return dict(b=batch, r=cfg.height // s, w=cfg.width // s,
                c={3: 64, 2: 32, 1: 16, 0: 8}[cfg.prior_scale],
                d=cfg.num_depth_bins, h=cfg.height // s,
                g=cfg.reg3d_c)
