from .checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_tuning_record,
    restore_train_state,
    save_checkpoint,
    save_tuning_record,
)
