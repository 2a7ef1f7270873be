from eigenpinns_torch.train.loop import LoopResult, run_chunked_loop
from eigenpinns_torch.train.optim import AdamPlateau, adam_exp_decay

__all__ = ["AdamPlateau", "adam_exp_decay", "LoopResult", "run_chunked_loop"]
