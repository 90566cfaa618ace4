"""merfish3d-tpu: JAX MERFISH post-processing framework for NVIDIA GPUs.

Capability-compatible with QI2lab/merfish3d-analysis; built on
JAX/XLA/Pallas with TensorStore-backed OME-NGFF v0.5 datastore I/O.
"""

__version__ = "0.1.0"

from .datastore.store import qi2labDataStore
from .pipeline.decoder import PixelDecoder
from .pipeline.registration import DataRegistration

__all__ = ["qi2labDataStore", "PixelDecoder", "DataRegistration"]
