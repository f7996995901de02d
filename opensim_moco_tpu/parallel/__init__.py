from .batch import batch_guesses, default_mesh, make_batched_solver
from .grid_shard import grid_sharded_eval
from .multihost import (global_batch_mesh, initialize as
                        initialize_distributed, solve_batch_multihost)

__all__ = ["make_batched_solver", "default_mesh", "batch_guesses",
           "grid_sharded_eval",
           "initialize_distributed", "global_batch_mesh",
           "solve_batch_multihost"]
