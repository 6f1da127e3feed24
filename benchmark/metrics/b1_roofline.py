"""B1 (``moments_kernel``): the least time of its launches in the traced
window (``bounds/b1.py``; one a member chunk an interaction of the
``streamed_field`` entry) over their profiled device time, in %."""

BYTES = {"float32": 4, "bfloat16": 2}


def read(run):
    config = run.cell.config
    serve, ds = config["serve"], config["dataset"]
    if serve["entry"] != "streamed_field" or serve["dtype"] not in BYTES:
        return None
    e = serve["chunk_members"]
    shape = {"e": e, "v": ds["xs"] * ds["ys"] * ds["zs"],
             "bytes_per_value": BYTES[serve["dtype"]]}
    shapes = [shape] * (len(run.actions) * (ds["members"] // e))
    return run.roofline("b1", r"\bmoments_kernel\b", shapes)
