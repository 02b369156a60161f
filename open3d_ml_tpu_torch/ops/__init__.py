"""Point-cloud ops of the port: the curve sort, the bucket pyramid, the
ragged rows and segment reductions, and grid subsampling."""

from .ragged import (RaggedArray, dense_to_ragged_mask, masked_max,
                     masked_mean, ragged_to_dense, reduce_subarrays_sum,
                     row_splits_to_segment_ids, segment_ids_to_row_splits,
                     segment_max, segment_mean, segment_sum)
from .subsample import grid_subsampling, grid_subsampling_batch

__all__ = ["RaggedArray", "dense_to_ragged_mask", "masked_max",
           "masked_mean", "ragged_to_dense", "reduce_subarrays_sum",
           "row_splits_to_segment_ids", "segment_ids_to_row_splits",
           "segment_max", "segment_mean", "segment_sum", "grid_subsampling",
           "grid_subsampling_batch"]
