"""operator_build_s: the port's operator build from the handed scipy K
(`<format>.from_scipy`, with its reordering) and the mass diagonal, host
clock around the call, ending on a synchronise."""


def read(ctx):
    return ctx["spans"]["operator_build"]
