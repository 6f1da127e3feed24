"""Cells cut to sizes a CPU test run holds."""

import torch

from benchmark import spec

CELLS = ("synthbox250-m1000-pearson-field", "linear4x4-pearson-drag",
         "linear4x4-ksg-drag", "linear4x4-ksg-orbit")
SEED = 2**31 + 4242
CPU = torch.device("cpu")


def tiny_cell(name: str):
    """The cell with its grid, members and frame cut (its limits kept)."""
    cell = spec.load_cell(name)
    ds = cell.config["dataset"]
    if cell.config["serve"]["entry"] == "scene":
        ds.update(xs=24, ys=20, zs=8, members=48)
        cell.config["serve"]["image_size"] = [64, 48]
    else:
        ds.update(xs=12, ys=10, zs=8, members=48)
        cell.config["serve"]["chunk_members"] = 12
    cell.settings["check"].update(interactions=2, within=4, voxels=64)
    return cell
