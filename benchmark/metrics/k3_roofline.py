"""K3 (``composite_taps_kernel`` and ``composite_kernel``): the least
time of the composites in the traced window (``bounds/k3.py``; one a
frame of the ``dvr`` renderer, at the camera's intermediate shape) over
the two kernels' profiled device time, in %."""

from benchmark.reference.dvr import intermediate_shape


def read(run):
    serve, ds = run.cell.config["serve"], run.cell.config["dataset"]
    if serve["entry"] != "scene" or serve["renderer"] != "dvr":
        return None
    zyx = (ds["zs"], ds["ys"], ds["xs"])
    shapes = []
    for a in run.actions:
        s, hi, wi, yv, xv = intermediate_shape(
            zyx, a["camera"], tuple(serve["image_size"]),
            float(serve.get("intermediate_scale", 1.0)))
        shapes.append({"s": s, "hi": hi, "wi": wi, "yv": yv, "xv": xv})
    return run.roofline("k3", r"\bcomposite(_taps)?_kernel\b", shapes)
