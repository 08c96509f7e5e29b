"""Crash-safe npz checkpoints in the reference's layout."""

from repro_torch.checkpoint.ckpt import (
    fleet_shard_dir,
    fleet_shard_name,
    host_skeleton,
    latest_step,
    list_fleet_shards,
    restore,
    restore_step,
    restore_subtree,
    save,
    save_step,
    step_metadata,
)

__all__ = [
    "fleet_shard_dir",
    "fleet_shard_name",
    "host_skeleton",
    "latest_step",
    "list_fleet_shards",
    "restore",
    "restore_step",
    "restore_subtree",
    "save",
    "save_step",
    "step_metadata",
]
