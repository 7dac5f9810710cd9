"""Data-parallel bring-up and collectives of the port."""

from .collectives import (all_gather_objects, broadcast_int,  # noqa: F401
                          psum_)
from .dist import (barrier, destroy_process_group,  # noqa: F401
                   device_for_rank, get_rank, get_world_size,
                   init_process, is_primary)
