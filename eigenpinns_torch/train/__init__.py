from eigenpinns_torch.train.loop import LoopResult, run_chunked_loop
from eigenpinns_torch.train.optim import AdamPlateau

__all__ = ["AdamPlateau", "LoopResult", "run_chunked_loop"]
