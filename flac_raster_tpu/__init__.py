"""flac-raster-tpu: JAX device-native lossless geospatial raster codec framework.

Rebuild of yharby/flac-raster's capabilities (GeoTIFF <-> FLAC conversion,
spatial tiling, HTTP range streaming) as a self-contained JAX/XLA
framework: the FLAC codec, GeoTIFF I/O, metadata container, and spatial
index are all first-party (the reference delegates these to libFLAC, GDAL,
and mutagen -- SURVEY.md §2.2).

Public API mirrors the reference's ``__init__.py:16-68`` export list so
reference recipes run unchanged, plus this framework's additions (exact
lossless modes, device-batched tile engine).
"""

from .codec.decoder import decode_flac, decode_flac_range
from .codec.device_encoder import encode_flac_device
from .codec.device_decoder import decode_flac_device
from .parallel.decode_mesh import decode_flac_batch_mesh
from .codec.encoder import encode_flac
from .codec.fast_encoder import encode_flac_batch, encode_flac_fast
from .compare import compare_tiffs, display_comparison_table
from .converter import RasterFLACConverter
from .io.geo import Affine, BoundingBox, Window
from .io.geotiff import open_geotiff, write_geotiff
from .io.remote import download_remote, is_remote_url, open_remote
from .models.spatial import (
    SpatialFLACEncoder,
    SpatialFLACStreamer,
    SpatialFrame,
    SpatialIndex,
)
from .models.streaming import create_streaming_flac, load_streaming_index
from .ops.normalization import (
    NormalizationParams,
    calculate_audio_params,
    denormalize_from_audio,
    denormalize_lossless,
    estimate_precision_loss,
    normalize_lossless,
    normalize_to_audio,
)
from .version import __version__

# Conditionally import async features (parity with reference __init__.py:29-40)
try:
    from .io.async_reader import (
        ASYNC_GEOTIFF_AVAILABLE,
        AsyncGeoTIFFReader,
        read_geotiff_async,
        read_tile_async,
    )
except ImportError:  # pragma: no cover
    ASYNC_GEOTIFF_AVAILABLE = False
    AsyncGeoTIFFReader = None
    read_geotiff_async = None
    read_tile_async = None

__all__ = [
    # Core converter
    "RasterFLACConverter",
    # Codec (first-party FLAC encoder/decoder family)
    "encode_flac",
    "encode_flac_fast",
    "encode_flac_device",
    "encode_flac_batch",
    "decode_flac",
    "decode_flac_range",
    "decode_flac_device",
    "decode_flac_batch_mesh",
    # Comparison utilities
    "compare_tiffs",
    "display_comparison_table",
    # Spatial encoding
    "SpatialFLACEncoder",
    "SpatialFLACStreamer",
    "SpatialIndex",
    "SpatialFrame",
    # Streaming container
    "create_streaming_flac",
    "load_streaming_index",
    # Normalization
    "normalize_to_audio",
    "denormalize_from_audio",
    "normalize_lossless",
    "denormalize_lossless",
    "calculate_audio_params",
    "NormalizationParams",
    "estimate_precision_loss",
    # Raster I/O
    "open_geotiff",
    "write_geotiff",
    "Affine",
    "Window",
    "BoundingBox",
    # Remote access
    "is_remote_url",
    "open_remote",
    "download_remote",
    # Async (optional)
    "ASYNC_GEOTIFF_AVAILABLE",
    "AsyncGeoTIFFReader",
    "read_geotiff_async",
    "read_tile_async",
    "__version__",
]
