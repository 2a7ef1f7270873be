"""train_job_overhead_ms (ms/job): the training window's device time in
the port's `train.prepare` and `train.finish` spans (a job's time
outside its chunked loop: X to the card, the network, the optimizer, the
loss operator's copy; the Rayleigh-Ritz finish and the copies to the
host) over its jobs."""

import program_spans


def read(ctx):
    t = program_spans.tracer()
    if ctx["job"] != "train" or t is None or not ctx["work"]["jobs"]:
        return None
    ms = program_spans.device_ms(t.records(),
                                 {"train.prepare", "train.finish"})
    return None if ms is None else ms / ctx["work"]["jobs"]
