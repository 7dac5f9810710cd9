"""Data-parallel bring-up and collectives of the port."""

from .collectives import (all_gather_, all_gather_objects,  # noqa: F401
                          broadcast_int, psum_, reduce_scatter_)
from .dist import (barrier, destroy_process_group,  # noqa: F401
                   device_for_rank, get_rank, get_world_size,
                   init_process, is_primary)
