"""Checkpoint IO and the DP-scheduled checkpoint manager."""
from .manager import CheckpointManager, restore_latest, save_checkpoint

__all__ = ["CheckpointManager", "restore_latest", "save_checkpoint"]
