"""Spawned ``torch.distributed`` worlds for the port's mesh tests.

``run_world(n, fn, out_dir, args)`` starts n spawn processes, each one
rank of a gloo world on a file rendezvous in ``out_dir`` (no TCP port, so
no collision between test workers), with one torch thread each.  Every
rank calls ``fn(mesh, *args)`` (a module-level function, sent by its
import path) with its ``ParseMesh`` on the CPU, and pickles the result;
the results come back in rank order.  Collectives time out after 120 s, and the
whole world after ``timeout`` seconds, which fails the test.

``run_launched(n, fn, out_dir, args)`` starts the n processes as torchrun
does: each gets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR (localhost) and
MASTER_PORT, no process group is made for it, and it calls
``fn(*args)``.  ``free_ports(k)`` gives k ports for MASTER_PORT.
"""

import datetime
import os
import pickle
import socket
import time

import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
WORLD_TIMEOUT_S = 300


def _dump(out_dir: str, rank: int, result):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _rank_main(rank: int, n: int, rdv: str, fn, args, out_dir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=n, timeout=COLLECTIVE_TIMEOUT)
    try:
        from pfbwtf_tpu_torch.parallel.sharded import make_parse_mesh

        result = fn(make_parse_mesh("cpu"), *args)
    finally:
        dist.destroy_process_group()
    _dump(out_dir, rank, result)


def _launched_main(rank: int, n: int, port: int, fn, args, out_dir: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch

    torch.set_num_threads(1)
    _dump(out_dir, rank, fn(*args))


def free_ports(k: int):
    """k distinct localhost ports that were free a moment ago."""
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run_world(n: int, fn, out_dir, args=(),
              timeout: float = WORLD_TIMEOUT_S):
    """Every rank's ``fn(mesh, *args)`` in a world of n ranks, in rank
    order."""
    out_dir = str(out_dir)
    return _run(n, _rank_main, lambda r: (
        r, n, os.path.join(out_dir, "rdv"), fn, tuple(args), out_dir),
        out_dir, timeout)


def run_launched(n: int, fn, out_dir, args=(),
                 timeout: float = WORLD_TIMEOUT_S):
    """Every process's ``fn(*args)`` under torchrun's variables for a
    world of n ranks (no process group made), in rank order."""
    out_dir = str(out_dir)
    port = free_ports(1)[0]
    return _run(n, _launched_main, lambda r: (
        r, n, port, fn, tuple(args), out_dir), out_dir, timeout)


def _run(n: int, target, args_of, out_dir: str, timeout: float):
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    assert not hung, f"ranks {hung} of {n} still ran after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * n, f"rank exit codes {codes}"
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
