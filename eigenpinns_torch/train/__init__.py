from eigenpinns_torch.train.checkpoint import (
    TrainCheckpointer,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from eigenpinns_torch.train.loop import LoopResult, run_chunked_loop
from eigenpinns_torch.train.optim import (
    Adam,
    AdamPlateau,
    AdamW,
    adam_exp_decay,
    adam_frozen,
    adamw_cosine_restarts,
    freeze_mask,
)

__all__ = ["Adam", "AdamPlateau", "AdamW", "adam_exp_decay", "adam_frozen",
           "adamw_cosine_restarts",
           "freeze_mask", "LoopResult", "run_chunked_loop",
           "TrainCheckpointer", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint"]
