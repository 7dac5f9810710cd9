"""Data-parallel bring-up and collectives of the port."""

from .collectives import broadcast_int, psum_  # noqa: F401
from .dist import (barrier, destroy_process_group,  # noqa: F401
                   device_for_rank, get_rank, get_world_size,
                   init_process, is_primary)
