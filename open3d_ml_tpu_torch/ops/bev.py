"""The BEV canvas of PointPillars' compact pillars.

Counterpart of ``open3d_ml_tpu/ops/bev.py`` ``bev_scatter``: each pillar's
slot index is scattered into its canvas cell, one int per pillar, and
every cell then gathers its pillar's feature row; empty cells are 0.
"""

import torch


def bev_scatter(pillar_feats, cells, num_cells):
    """Place pillar rows into a flat canvas.

    Args:
        pillar_feats: [B, V, C] pillar features.
        cells: [B, V] int canvas cell of each pillar, unique within a
            batch row; an invalid pillar has a cell >= num_cells and is
            dropped.
        num_cells: the canvas size (ny * nx).

    Returns [B, num_cells, C], empty cells 0.
    """
    b, v, c = pillar_feats.shape
    dev = pillar_feats.device
    # column num_cells takes every dropped pillar and is cut off
    slot = torch.full((b, num_cells + 1), -1, dtype=torch.int64, device=dev)
    slot.scatter_(1, cells.long().clamp(max=num_cells),
                  torch.arange(v, device=dev).expand(b, v))
    slot = slot[:, :num_cells]
    rows = torch.take_along_dim(pillar_feats, slot.clamp(min=0)[..., None],
                                dim=1)
    return torch.where(slot[..., None] >= 0, rows, 0.0)
