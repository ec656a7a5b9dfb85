from repro_torch.optim.adam import AdamState, adamw_init, adamw_update

__all__ = ["AdamState", "adamw_init", "adamw_update"]
