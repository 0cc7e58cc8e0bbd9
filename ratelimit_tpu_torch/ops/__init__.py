from .prefix import per_slot_inclusive_prefix
from .prefix_cuda import per_slot_inclusive_prefix_cuda

__all__ = ["per_slot_inclusive_prefix", "per_slot_inclusive_prefix_cuda"]
