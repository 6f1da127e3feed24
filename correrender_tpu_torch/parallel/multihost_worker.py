"""Per-process worker of the multi-host path, and a local launcher.

Counterpart of ``correrender_tpu/parallel/multihost_worker.py`` (and of
``tools/multihost_run.py``, which stays the JAX package's). One worker
runs a process (``python -m
correrender_tpu_torch.parallel.multihost_worker``), one device each.
Each worker:

1. joins the process group (:func:`multihost.initialize_process`:
   ``tcp://`` with ``--coordinator``, else ``env://`` as ``torchrun``
   sets it up; NCCL on the card, gloo with ``--device cpu``),
2. builds the ``(space, members)`` mesh over the processes,
3. loads ONLY its members from the NetCDF or Zarr store and keeps its
   Z-block of them,
4. runs the member-sharded Pearson (moments all-reduced across
   processes), the member → space reshard (``all_to_all``) and
   Spearman on the resharded layout,
5. gathers the results; process 0 validates them against float64 numpy
   and writes the evidence JSON, with the keys of the JAX package's
   (``MULTIHOST_r05.json``).

On the card run one process a GPU: ``torchrun --nproc-per-node <GPUs>
-m correrender_tpu_torch.parallel.multihost_worker --space S --members M
--dataset D``, or :func:`launch`, whose workers run on the card unless
the caller passes ``device="cpu"``: then they are gloo processes on
localhost.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rank_f64(a: np.ndarray) -> np.ndarray:
    """Average-tie ranks along the last axis (``scipy.stats.rankdata``
    semantics), float64: each run of equal sorted values takes the mean
    of its positions."""
    n = a.shape[-1]
    flat = a.reshape(-1, n)
    order = np.argsort(flat, axis=-1, kind="stable")
    s = np.take_along_axis(flat, order, axis=-1)
    pos = np.broadcast_to(np.arange(n), s.shape)
    starts = np.ones(s.shape, bool)
    starts[:, 1:] = s[:, 1:] != s[:, :-1]
    ends = np.ones(s.shape, bool)
    ends[:, :-1] = starts[:, 1:]
    first = np.maximum.accumulate(np.where(starts, pos, 0), axis=-1)
    last = np.minimum.accumulate(np.where(ends, pos, n - 1)[:, ::-1],
                                 axis=-1)[:, ::-1]
    ranks = np.empty(s.shape, np.float64)
    np.put_along_axis(ranks, order, (first + last) / 2.0 + 1.0, axis=-1)
    return ranks.reshape(a.shape)


def _pearson_f64(stack: np.ndarray, ref: np.ndarray) -> np.ndarray:
    x = ref.astype(np.float64)
    y = stack.astype(np.float64)
    xm = x - x.mean()
    ym = y - y.mean(axis=-1, keepdims=True)
    num = (ym * xm).sum(-1)
    den = np.sqrt((xm * xm).sum() * (ym * ym).sum(-1))
    with np.errstate(invalid="ignore", divide="ignore"):
        return num / den


def _max_delta_slabs(got: np.ndarray, stack: np.ndarray, ref: np.ndarray,
                     ranked: bool, planes: int = 2) -> float:
    """max |got − float64 Pearson (of ranks when ``ranked``)| over the
    finite voxels, ``planes`` Z-planes a task on every host core (numpy
    releases the GIL in the sorts and sums; host memory stays bounded)."""
    if ranked:
        ref = _rank_f64(ref[None])[0]

    def slab(z0):
        blk = stack[z0:z0 + planes]
        want = _pearson_f64(_rank_f64(blk) if ranked else blk, ref)
        diff = np.abs(got[z0:z0 + planes] - want)
        return float(np.nanmax(diff)) if np.isfinite(diff).any() else 0.0

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return max(pool.map(slab, range(0, stack.shape[0], planes)),
                   default=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's store (tcp://); "
                         "default: env:// as torchrun sets it up")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=1,
                    help="accepted and ignored: a process drives one "
                         "device")
    ap.add_argument("--space", type=int, required=True)
    ap.add_argument("--members", type=int, required=True,
                    help="members mesh-axis size")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--field", default=None)
    ap.add_argument("--ref", default=None,
                    help="reference voxel z,y,x (default: center)")
    ap.add_argument("--out", default=None,
                    help="process 0 writes the evidence JSON here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from correrender_tpu_torch.calculators.correlation import (
        correlate_field,
    )
    from correrender_tpu_torch.io.base import loader_for_path
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.parallel import multihost as mh
    from correrender_tpu_torch.parallel.mesh import reshard_member_to_space
    from correrender_tpu_torch.parallel.pearson_sharded import (
        correlate_space_sharded,
        pearson_member_sharded,
    )

    device = mh.initialize_process(args.coordinator, args.num_processes,
                                   args.process_id,
                                   local_devices=args.local_devices,
                                   platform=args.device)
    pid = dist.get_rank()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed_ms(fn):
        fn()  # warm-up
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def launched():
        sync()
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    result = None
    try:
        mesh = mh.process_spanning_mesh(args.space, args.members,
                                        device_type=device.type)
        # -- per-process input: only this process's members -----------
        loader = loader_for_path(args.dataset).open(args.dataset)
        field = args.field or loader.field_names[0]
        num_members = int(loader.es)
        lo, hi = mh.process_member_range(mesh, num_members)
        t0 = time.perf_counter()
        # Member-major, then viewed member-last: stacking along the last
        # axis on the host would interleave the members value by value.
        local = np.moveaxis(np.stack(
            [loader.load_field(field, time=0, member=e)
             for e in range(lo, hi)]).astype(np.float32, copy=False), 0, -1)
        t_load = time.perf_counter() - t0
        close = getattr(loader, "close", None)
        if close is not None:
            close()
        zs, ys, xs = local.shape[:3]
        if args.ref:
            rz, ry, rx = (int(v) for v in args.ref.split(","))
        else:
            rz, ry, rx = zs // 2, ys // 2, xs // 2
        stack = mh.member_stack_from_local(local, mesh, num_members)
        ref = mh.member_series_from_local(
            np.ascontiguousarray(local[rz, ry, rx, :]), mesh, num_members)
        del local

        # -- member-sharded Pearson, the reshard, Spearman after it ----
        r, pearson_ms = timed_ms(
            lambda: pearson_member_sharded(stack, ref, mesh))
        (rstack, smesh), reshard_ms = timed_ms(
            lambda: reshard_member_to_space(stack, mesh))
        full_ref = mh.replicate_to_host(ref, mesh, "series")
        _build.reset_launch_counts()
        sp = correlate_space_sharded(
            rstack, torch.as_tensor(full_ref, device=device), smesh,
            "spearman")
        spearman_launches = launched()

        # -- gathers (collectives: every process joins) ----------------
        pearson_np = mh.replicate_to_host(r, mesh, "field")
        spearman_np = mh.replicate_to_host(sp, smesh, "space")
        gathered = mh.replicate_to_host(stack, mesh, "stack")
        gathered_r = mh.replicate_to_host(rstack, smesh, "space")
        del stack, rstack
        if pid == 0:
            t0 = time.perf_counter()
            reshard_delta = float(np.abs(gathered - gathered_r).max())
            del gathered_r
            d_p = _max_delta_slabs(pearson_np, gathered, full_ref, False)
            # The single-process estimator on the gathered stack (K1 on
            # the card, its plain version on the CPU).
            gathered_t = torch.as_tensor(gathered, device=device)
            full_ref_t = torch.as_tensor(full_ref, device=device)
            _build.reset_launch_counts()
            single = correlate_field(gathered_t, full_ref_t,
                                     "pearson").cpu().numpy()
            single_launches = launched()
            del gathered_t
            d_sp = float(np.nanmax(np.abs(pearson_np - single)))
            d_s = _max_delta_slabs(spearman_np, gathered, full_ref, True)
            validate_s = time.perf_counter() - t0
            result = {
                "ok": bool(d_p < 1e-4 and d_s < 1e-4 and d_sp < 1e-5
                           and reshard_delta == 0.0),
                "num_processes": int(dist.get_world_size()),
                "local_devices": 1,
                "mesh": f"{args.space}x{args.members}",
                "grid": [int(zs), int(ys), int(xs)],
                "members": int(num_members),
                "members_loaded_per_process": int(hi - lo),
                "pearson_max_delta_vs_f64": d_p,
                "pearson_max_delta_vs_singleproc": d_sp,
                "spearman_max_delta_vs_f64": d_s,
                "reshard_max_delta": reshard_delta,
                "pearson_warm_ms": pearson_ms,
                "reshard_warm_ms": reshard_ms,
                "load_s_per_process": t_load,
                "store": args.dataset.rstrip("/").rsplit(".", 1)[-1],
                "device": str(device),
                "validate_s": validate_s,
                # Kernel launches (ops/cuda/_build.LAUNCHES, the nonzero
                # counts; none on the CPU) of this process's Spearman and
                # of the single-process Pearson.
                "spearman_launches": spearman_launches,
                "singleproc_launches": single_launches,
            }
            text = json.dumps(result)
            print(text, flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(text + "\n")
    finally:
        dist.destroy_process_group()
    return 0 if (pid != 0 or result["ok"]) else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(processes, space, members, dataset, out, device, timeout,
                 port):
    """Start the workers, join each with its own deadline; their exit
    codes and output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(processes):
        cmd = [sys.executable, "-m",
               "correrender_tpu_torch.parallel.multihost_worker",
               "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", str(processes),
               "--process-id", str(pid),
               "--space", str(space), "--members", str(members),
               "--dataset", dataset, "--device", device]
        if pid == 0:
            cmd += ["--out", out]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    rcs, logs = [], []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            text, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text = (text or "") + "\n[launch] timed out"
        rcs.append(p.returncode)
        logs.append(text or "")
    return rcs, logs


def launch(processes=2, space=None, members=None, dataset=None, out=None,
           device="cuda", timeout=600.0) -> dict:
    """Run the worker in ``processes`` local processes over
    ``tcp://127.0.0.1:<free port>`` and return process 0's evidence.

    The workers run on the card (NCCL, one process a GPU) unless
    ``device="cpu"`` (gloo). ``space`` defaults to ``processes`` and
    ``members`` to ``processes // space``. Each worker is joined with the time left of
    ``timeout`` seconds and killed past it. The port is picked by binding
    to port 0, so another program may take it before process 0 binds it:
    such a run is retried once on a new port. Raises ``RuntimeError``
    with the workers' output if any exits non-zero.
    """
    space = processes if space is None else space
    members = processes // space if members is None else members
    if space * members != processes:
        raise ValueError(f"mesh {space}x{members} != {processes} processes")
    if out is None:
        out = os.path.join(os.path.dirname(os.path.abspath(dataset)),
                           "multihost.json")
    for attempt in range(2):
        rcs, logs = _run_workers(processes, space, members, dataset, out,
                                 device, timeout, _free_port())
        if rcs == [0] * processes and os.path.exists(out):
            with open(out) as f:
                return json.loads(f.read())
        if not any("EADDRINUSE" in log or "address already in use"
                   in log.lower() for log in logs):
            break
    report = "\n".join(f"--- worker {i} (rc={rc}) ---\n{log[-4000:]}"
                       for i, (rc, log) in enumerate(zip(rcs, logs)))
    raise RuntimeError(f"multihost run failed:\n{report}")


if __name__ == "__main__":
    raise SystemExit(main())
