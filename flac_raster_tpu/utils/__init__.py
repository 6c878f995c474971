from .profiling import StageTimer, device_trace, timed_stage

__all__ = ["StageTimer", "device_trace", "timed_stage"]
