from .telemetry import Histogram, Telemetry, get_telemetry

__all__ = ["Histogram", "Telemetry", "get_telemetry"]
