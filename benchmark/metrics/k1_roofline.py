"""K1 (``pearson_tiled_kernel`` or ``pearson_direct_kernel``): the least
time of its launches in the traced window (``bounds/k1.py``; one a
point move of a Pearson Scene) over their profiled device time, in %."""


def read(run):
    config, mix = run.cell.config, run.cell.traffic
    if config["serve"]["entry"] != "scene" or mix["measure"] != "pearson":
        return None
    ds = config["dataset"]
    shape = {"v": ds["xs"] * ds["ys"] * ds["zs"], "n": ds["members"]}
    shapes = [shape for a in run.actions if "point" in a]
    return run.roofline("k1", r"\bpearson_(tiled|direct)_kernel\b", shapes)
