"""Point-cloud set abstraction (the paper's second application domain):
farthest-point sampling, ball-query grouping and grouped max-pool
aggregation, on the hand-written kernels K9–K13 (``pointcloud/kernels.py``)
with their plain PyTorch versions (``pointcloud/ref.py``).
"""

from repro_torch.pointcloud.ops import (
    ball_query,
    farthest_point_sample,
    group_aggregate,
)
from repro_torch.pointcloud.ref import (
    ball_query_ref,
    fps_ref,
    group_aggregate_ref,
)

__all__ = [
    "ball_query",
    "farthest_point_sample",
    "group_aggregate",
    "ball_query_ref",
    "fps_ref",
    "group_aggregate_ref",
]
