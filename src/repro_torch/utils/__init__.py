from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer, measure_wall_time

__all__ = ["get_logger", "Timer", "measure_wall_time"]
