"""Distribution: DOF-sharded (v2) and element-sharded (v1) Newton solves
over a shard communicator (`Solver: shards`, the CLI's --shards)."""
