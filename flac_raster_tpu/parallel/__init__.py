from .decode_mesh import decode_flac_batch_mesh
from .mesh import Mesh, NamedSharding, P, tile_mesh, tile_sharding
from .tile_engine import encode_flac_batch_mesh, make_tile_emit_step

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "tile_mesh",
    "tile_sharding",
    "make_tile_emit_step",
    "encode_flac_batch_mesh",
    "decode_flac_batch_mesh",
]
