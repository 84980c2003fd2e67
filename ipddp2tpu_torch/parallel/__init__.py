"""Time-parallel and multi-process layers of the port (`torch.distributed`):
the associative-scan Riccati pass (`priccati`), its time-sharded value scan
(`timeshard`), batch sharding (`mesh`) and the multi-process entry
(`multihost`)."""

from .mesh import make_mesh, sharded_batch_stats, solve_sharded
from .timeshard import value_scan_timesharded

__all__ = ["make_mesh", "solve_sharded", "sharded_batch_stats",
           "value_scan_timesharded"]
