from . import generators
from .csr import (CSRGraph, DeviceGraph, dst_indptr, from_edges,
                  from_numpy_fields, to_device)

__all__ = ["CSRGraph", "DeviceGraph", "dst_indptr", "from_edges",
           "from_numpy_fields", "generators", "to_device"]
