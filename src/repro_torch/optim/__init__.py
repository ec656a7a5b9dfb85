"""Optimizers on trees of tensors, and the lr schedules."""
from repro_torch.optim.adam import AdamState, adamw_init, adamw_update, sgd_update
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "AdamState",
    "adamw_init",
    "adamw_update",
    "sgd_update",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
]
