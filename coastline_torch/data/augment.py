"""Batched data augmentation on the device (counterpart of
`coastline/data/augment.py`).

The reference augments on the host with torchvision: RandomHorizontalFlip
(0.5), RandomRotation(10), ColorJitter(0.1, 0.1, 0.1)
(`train_water_segmentation.py:313-321`), and moves the image only. Here
each transform is a function of explicit per-sample parameters, written
with index gathers as the JAX package writes it, and `make_augment_fn`
draws the parameters from a `torch.Generator` on the device. Geometric
transforms move the image and the mask together by default;
`image_only_geometric=True` keeps the reference's behaviour.

Images are (N, H, W, 3) float32 in [0, 1], before normalization; masks
(N, H, W).
"""

import math

import torch


def flip(x, do_flip):
    """Mirror each sample along W where `do_flip` (N,) is true; x (N, H, W, ...)."""
    keep = do_flip.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x.flip(2), x)


def rotate(img, angle, nearest: bool = False):
    """Rotate each (H, W, C) sample of `img` (N, H, W, C) about its centre
    by `angle` (N,) radians, zero fill outside (torchvision RandomRotation:
    expand=False, fill=0). The inverse map of `_rotate_bilinear`: output
    pixel -> input coordinates, then four zero-filled bilinear taps, or with
    `nearest` the round-half-even pixel inside -0.5 <= src <= size - 0.5."""
    n, h, w, _ = img.shape
    dev = img.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, device=dev, dtype=torch.float32) - cy)[None, :, None]
    xx = (torch.arange(w, device=dev, dtype=torch.float32) - cx)[None, None, :]
    cos = torch.cos(angle.float())[:, None, None]
    sin = torch.sin(angle.float())[:, None, None]
    src_x = cos * xx + sin * yy + cx
    src_y = -sin * xx + cos * yy + cy
    b = torch.arange(n, device=dev)[:, None, None]
    if nearest:
        sx = torch.round(src_x).long().clamp(0, w - 1)
        sy = torch.round(src_y).long().clamp(0, h - 1)
        inb = (src_x >= -0.5) & (src_x <= w - 0.5) & (src_y >= -0.5) & (src_y <= h - 0.5)
        return torch.where(inb[..., None], img[b, sy, sx], torch.zeros((), dtype=img.dtype,
                                                                      device=dev))
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    fx, fy = (src_x - x0)[..., None], (src_y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        v = img[b, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return v * inb[..., None]

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x0i + 1) * fx * (1 - fy)
            + tap(y0i + 1, x0i) * (1 - fx) * fy + tap(y0i + 1, x0i + 1) * fx * fy)


def color_jitter(img, brightness, contrast, saturation):
    """Brightness, then contrast (a blend with the mean of the grey image),
    then saturation (a blend with the grey image), each by its (N,) factor,
    clipped to [0, 1] after each; the grey image is taken once, after the
    brightness step, as in the JAX package (torchvision draws the order at
    random; the factors commute to first order at 0.1)."""

    def per_sample(f):
        return f.reshape(-1, 1, 1, 1)

    img = torch.clamp(img * per_sample(brightness), 0.0, 1.0)
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    gmean = per_sample(gray.mean((1, 2)))
    img = torch.clamp((img - gmean) * per_sample(contrast) + gmean, 0.0, 1.0)
    return torch.clamp((img - gray[..., None]) * per_sample(saturation) + gray[..., None], 0.0, 1.0)


def make_augment_fn(max_rotate_deg: float = 10.0, flip_prob: float = 0.5, jitter: float = 0.1,
                    image_only_geometric: bool = False):
    """`augment(gen, images01, masks) -> (images01, masks)` for the train
    step. Per sample it draws, in one `torch.rand((N, 5), generator=gen)`, a
    flip (Bernoulli `flip_prob`), an angle U(+-max_rotate_deg) and the
    brightness, contrast and saturation factors U(1 +- jitter); then flips,
    rotates (bilinear) and jitters the batch, and flips and rotates the mask
    (nearest) unless `image_only_geometric`. With `rows = (start, total)`
    the batch is rows [start, start + N) of one of `total` split over ranks:
    the parameters are drawn for the whole batch and this rank keeps its
    rows, so every sample is augmented as in one process."""

    def augment(gen, images, masks, rows=None):
        n = images.shape[0]
        if rows is None:
            u = torch.rand((n, 5), generator=gen, device=images.device)
        else:
            start, total = rows
            u = torch.rand((total, 5), generator=gen, device=images.device)[start:start + n]
        do_flip = u[:, 0] < flip_prob
        angle = (u[:, 1] * 2 - 1) * max_rotate_deg * (math.pi / 180.0)
        images = rotate(flip(images, do_flip), angle)
        if jitter:
            b, c, s = (1 - jitter + 2 * jitter * u[:, k] for k in (2, 3, 4))
            images = color_jitter(images, b, c, s)
        if not image_only_geometric:
            m = flip(masks, do_flip)[..., None].float()
            masks = rotate(m, angle, nearest=True)[..., 0].to(masks.dtype)
        return images, masks

    return augment
