from .adam import AdamState, adam_init, adam_update, adamw_update
from .schedule import cosine_warmup

__all__ = ["AdamState", "adam_init", "adam_update", "adamw_update", "cosine_warmup"]
