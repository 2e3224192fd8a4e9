from .adam import AdamState, adam_init, adam_update

__all__ = ["AdamState", "adam_init", "adam_update"]
