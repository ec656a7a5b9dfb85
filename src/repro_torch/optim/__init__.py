"""Optimizers on dicts of tensors. The reference's lr schedules wait
(ROADMAP A8.3)."""
from repro_torch.optim.adam import AdamState, adamw_init, adamw_update, sgd_update

__all__ = ["AdamState", "adamw_init", "adamw_update", "sgd_update"]
