from . import goodput, spans
from .telemetry import (Histogram, Telemetry, get_telemetry,
                        sample_device_memory)

__all__ = ["Histogram", "Telemetry", "get_telemetry", "sample_device_memory",
           "goodput", "spans"]
