from .store import save_checkpoint, restore_checkpoint, latest_step, \
    CheckpointManager
