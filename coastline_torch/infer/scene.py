"""Scene prediction on the device: upload once, tile, forward, stitch,
band (counterpart of `coastline/infer/scene.py`).

The host tiling path (`data/tiling.py` + chunked `predict_masks_batch`)
cuts every overlapping tile on the host, uploads each chunk and downloads
each chunk's masks. This path uploads the scene once, zero-pads it on the
device, cuts one chunk of tiles at a time (a strided view of the padded
scene indexed by the chunk's grid positions: `batch` tiles are
materialized, never the whole grid), runs the extractor's forward per
chunk, and stitches all tile masks in one gather that picks, for each
output pixel, the tile `stitch_tiles` would have written last: its
row-major overwrite with half-overlap crops makes that tile the last row
of tiles whose crop covers the pixel's row and the last column whose crop
covers its column. With `band_dilation` the coastline band is taken from
the stitched mask where it lies, so the dilation kernel runs on the card
with no download in between.

The output equals the host path bit for bit: the same grid, zero padding,
batch padding and crops, and the same forward on the same tiles.

With a `mesh` (`parallel/mesh.py`, called on every rank) the chunks are
dealt over the mesh's data groups in turn: group g of k forwards chunks g,
g + k, ..., each whole, the same `batch` tiles at the same batch positions
as one device forwards them. So every tile's mask is one device's bit for
bit: cuDNN's bf16 convolutions round by batch size and by a sample's
position in the batch (on the H100 a 512^2 UNet's 32^2 bottleneck conv
gives other bits for a tile at batch 4 than at batch 8, and at position 4
than at position 0), so splitting each chunk's rows over the ranks, as
the JAX package shards its chunk batch, would not. The tile masks are
gathered in order (`parallel/collectives.py::gather`, one collective a
scene), and every rank stitches, and takes the band of, the whole scene.

With a 'space' axis the ranks of one space group forward the same chunks,
each its rows of every tile (`batch_sharding(mesh).rows_of`) inside
`collectives.split_rows`, so the layers exchange their halo rows; each
chunk's mask rows are gathered back over the space group
(`collectives.gather_rows`), and the stitch and band run as above. In
float32 on the CPU the tile masks equal one device's bit for bit.
"""

from typing import Callable, Optional

import numpy as np
import torch

from coastline_torch.infer.morphology import coastline_band
from coastline_torch.parallel import collectives


def _owners(n_tiles: int, stride: int, tile: int, half: int, length: int):
    """For each of `length` pixels along one axis: the index of the last
    tile whose crop covers it (`stitch_tiles`' overwrite order) and the
    pixel's offset inside that tile."""
    owner = np.zeros((n_tiles - 1) * stride + tile, np.int64)
    for i in range(n_tiles):
        owner[i * stride + (half if i > 0 else 0):i * stride + tile] = i
    owner = owner[:length]
    return owner, np.arange(length) - owner * stride


def build_scene_fn(predict_fn: Callable, h: int, w: int, channels: int, tile: int,
                   overlap: int, batch: int, band_dilation: Optional[int] = None,
                   mesh=None) -> Callable:
    """A function (h, w, channels) uint8 tensor -> (h, w) uint8 mask tensor
    on the scene's device, or (mask, band) with `band_dilation` set.

    `predict_fn` maps a (b, tile, tile, channels) uint8 tensor to (b, tile,
    tile) uint8 masks on the same device (the extractor's forward). Nothing
    waits for the device: the results are queued. With `mesh` the chunks
    are dealt over its data groups and the function is called on every
    rank with the same scene."""
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f"overlap ({overlap}) must be smaller than tile ({tile})")
    share = owners = rows = space = None
    if mesh is not None:
        from coastline_torch.parallel import mesh as pmesh

        share = pmesh.dataset_sharding(mesh)  # this rank's data group, of how many
        # the gather is by rank: keep the first rank of each data group
        owners = mesh.mesh.flatten().tolist()[::pmesh.model_axis_size(mesh)
                                              * pmesh.space_axis_size(mesh)]
        space = pmesh.space_group(mesh)
        rows = pmesh.batch_sharding(mesh).rows_of(tile)
    ny = max(1, -(-max(h - overlap, 1) // stride))
    nx = max(1, -(-max(w - overlap, 1) // stride))
    n = ny * nx
    hp, wp = (ny - 1) * stride + tile, (nx - 1) * stride + tile
    half = overlap // 2
    grid_y, grid_x = np.divmod(np.arange(n), nx)
    owner_y, off_y = _owners(ny, stride, tile, half, h)
    owner_x, off_x = _owners(nx, stride, tile, half, w)

    def run(scene_u8: torch.Tensor):
        if tuple(scene_u8.shape) != (h, w, channels) or scene_u8.dtype != torch.uint8:
            raise ValueError(f"expected uint8 {(h, w, channels)}, got {scene_u8.dtype} "
                             f"{tuple(scene_u8.shape)}")
        dev = scene_u8.device
        gy, gx, oy, ox, ly, lx = (torch.from_numpy(a).to(dev) for a in
                                  (grid_y, grid_x, owner_y, owner_x, off_y, off_x))
        padded = torch.zeros((hp, wp, channels), dtype=torch.uint8, device=dev)
        padded[:h, :w] = scene_u8
        # tile (iy, ix) is grid[iy, ix]: a view, no copy
        grid = padded.as_strided((ny, nx, tile, tile, channels),
                                 (stride * wp * channels, stride * channels, wp * channels,
                                  channels, 1))
        n_chunks = -(-n // batch)
        group, groups = (0, 1) if share is None else (share.index, share.count)
        n_local = -(-n_chunks // groups)  # this data group's chunks: group, group + groups, ...
        masks = torch.empty((n_local, batch, tile, tile), dtype=torch.uint8, device=dev)
        for c in range(n_local):
            start = (c * groups + group) * batch
            k = min(batch, n - start)
            if k <= 0:  # past the grid: the ranks' shares stay one shape
                masks[c] = 0
                continue
            chunk = torch.zeros((batch, tile, tile, channels), dtype=torch.uint8, device=dev)
            chunk[:k] = grid[gy[start:start + k], gx[start:start + k]]
            if space is None:
                masks[c] = predict_fn(chunk)
                continue
            with collectives.split_rows(space, tile, tile) as split:  # this rank's tile rows
                local = predict_fn(chunk[:, rows].contiguous())
                masks[c] = collectives.gather_rows(local[:, None], split, tile)[:, 0]
        if share is not None:  # (ranks, local chunks) -> chunks in scene order
            masks = collectives.gather(masks)[owners].transpose(0, 1)
        by_tile = masks.reshape(-1, tile, tile)[:n].view(ny, nx, tile, tile)
        mask = by_tile[oy[:, None], ox[None, :], ly[:, None], lx[None, :]]
        if band_dilation is None:
            return mask
        return mask, coastline_band(mask, band_dilation, device=dev)

    return run
