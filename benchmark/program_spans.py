"""What the readers of the port's own spans and counters share.

The port records them itself (`eigenpinns_torch/utils/profiling.py`)
while a profiler runs, so in a traced window alone: a span's `device_ms`
is the stream's time from reaching its start to reaching its end, the
card's idle inside it included; a `sync.*` counter counts the host's
waits for the card at one call site. A port without the tracer, or a
window that recorded nothing (no card, no trace), reads nothing.
"""


def tracer():
    """The port's tracer, or None where the port has none."""
    try:
        from eigenpinns_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def device_ms(records: list, names: set, parent=False):
    """The summed device ms of the spans named in `names` (with `parent`
    given, of those directly inside a span of that name); None where
    there is none, or one without a device time."""
    times = [r["device_ms"] for r in records if r["name"] in names
             and (parent is False or r["parent"] == parent)]
    if not times or None in times:
        return None
    return sum(times)


def polish_tracer(ctx):
    """The tracer and the window's LOBPCG iterations, or (None, None)
    outside a polish window or without the tracer."""
    t = tracer()
    if ctx["job"] != "polish" or t is None or not ctx["work"]["iterations"]:
        return None, None
    return t, ctx["work"]["iterations"]


def polish_spans_ms_per_iter(ctx, name: str):
    """The polish window's device ms in the spans `name` over its LOBPCG
    iterations."""
    t, iterations = polish_tracer(ctx)
    ms = None if t is None else device_ms(t.records(), {name})
    return None if ms is None else ms / iterations


def polish_syncs_per_iter(ctx, site: str):
    """The polish window's host syncs counted at `site` (the counter
    `sync.<site>`) over its LOBPCG iterations."""
    t, iterations = polish_tracer(ctx)
    n = None if t is None else t.counters().get("sync." + site)
    return None if n is None else n / iterations
