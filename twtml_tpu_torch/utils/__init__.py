from .rounding import round_half_up, torch_round_half_up

__all__ = ["round_half_up", "torch_round_half_up"]
