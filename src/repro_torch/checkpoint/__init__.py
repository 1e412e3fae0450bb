"""Checkpoints in the JAX package's file format (npz + msgpack manifest,
per-array CRC32, atomic rename), read and written with numpy and torch."""

from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    CorruptCheckpoint,
    all_steps,
    latest_step,
    load_arrays,
    restore_checkpoint,
    save_arrays,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "CorruptCheckpoint", "save_checkpoint",
           "restore_checkpoint", "save_arrays", "load_arrays",
           "all_steps", "latest_step"]
