"""B10 (``ksg_banded_kernel``): the least time of the KSG field's work
in the traced window (``bounds/b10.py``; one field a point move of a
Kraskov MI Scene) over the kernel's profiled device time, in %."""


def read(run):
    config, mix = run.cell.config, run.cell.traffic
    if config["serve"]["entry"] != "scene" or \
            mix["measure"] != "mi_kraskov":
        return None
    ds = config["dataset"]
    shape = {"v": ds["xs"] * ds["ys"] * ds["zs"], "n": ds["members"],
             "k": int(mix.get("k", 3))}
    shapes = [shape for a in run.actions if "point" in a]
    return run.roofline("b10", r"\bksg_banded_kernel\b", shapes)
