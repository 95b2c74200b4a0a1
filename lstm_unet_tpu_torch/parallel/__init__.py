"""Multi-process runs: process groups, the 'data' / 'spatial' mesh and the
halo exchange (counterpart of ``lstm_unet_tpu/parallel``)."""

from .distributed import initialize, is_writer, run_ranks
from .halo import exchange_halo_h, halo_conv2d
from .mesh import Mesh, Split, make_mesh, mesh_axis_sizes, plan_split

__all__ = ["initialize", "is_writer", "run_ranks", "exchange_halo_h", "halo_conv2d", "Mesh",
           "Split", "make_mesh", "mesh_axis_sizes", "plan_split"]
