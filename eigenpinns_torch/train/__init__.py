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
    adam_exp_decay,
    adam_frozen,
    freeze_mask,
)

__all__ = ["Adam", "AdamPlateau", "adam_exp_decay", "adam_frozen",
           "freeze_mask", "LoopResult", "run_chunked_loop",
           "TrainCheckpointer", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint"]
