from .logging import get_logger
from .rounding import round_half_up, torch_round_half_up

__all__ = ["get_logger", "round_half_up", "torch_round_half_up"]
