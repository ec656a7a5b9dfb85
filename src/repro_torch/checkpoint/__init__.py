"""Msgpack pytree checkpoints in the reference's format (``ckpt.py``),
read and written by the port's own codec (``_msgpack.py``)."""
from repro_torch.checkpoint.ckpt import (
    checkpoint_steps,
    latest_step,
    load_checkpoint,
    load_latest,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "load_checkpoint", "load_latest", "latest_step",
           "checkpoint_steps"]
