"""Multi-process runtime bring-up: ``torch.distributed`` from env or CLI,
one place (the counterpart of ``repro/launch/distributed.py``).

A deployment of P processes, one rank (one gossip node) each, is
described by three values:

  coordinator address   REPRO_COORDINATOR_ADDRESS   --coordinator
  process count         REPRO_NUM_PROCESSES         --num-processes
  process id            REPRO_PROCESS_ID            --process-id

CLI flags override env; env alone is enough.  The coordinator address is
``host:port`` (a TCP store that rank 0 serves) or any
``torch.distributed`` URL, such as ``file:///path/to/store``.  The reference's fourth
value, a count of fake host devices, has no counterpart: here a rank is a
process.

The backend is explicit:

* ``nccl`` needs one card per rank: rank i runs on ``cuda:i``, and more
  ranks than cards raise.
* ``gloo`` serves the CPU, and ranks that share a card (rank i on
  ``cuda:(i % cards)``).  Gloo's send and receive move host memory, so
  under gloo the gossip mixer (``repro_torch.dist.gossip``) stages each
  message on the card through a pinned host buffer; the combine still
  runs on the card.

:func:`spawn_local` starts N local ranks (``torch.multiprocessing`` with
the ``spawn`` start method) and returns each rank's result to the caller;
it stands in for the reference's ``--devices N``.

``python -m repro_torch.launch.distributed --smoke`` is the per-process
bring-up smoke that ``scripts/launch_multiprocess_torch.sh`` starts in
each of P processes through the env contract above (the reference's
``scripts/launch_multiprocess.sh``): each process joins the group, sums
a tensor on its own device (``cuda`` unless ``--device cpu``) and prints
one ``SMOKE_OK proc=i/P ...`` line; ``--global-collective`` adds an
``all_reduce`` over every process, which gloo runs on the CPU too (the
reference's JAX CPU backend cannot).
"""
from __future__ import annotations

import argparse
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class DistributedConfig:
    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got "
                             f"{self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(f"process_id {self.process_id} not in "
                             f"[0, {self.num_processes})")
        if self.num_processes > 1 and not self.coordinator_address:
            raise ValueError("multi-process config needs a coordinator "
                             "address (REPRO_COORDINATOR_ADDRESS or "
                             "--coordinator)")


def config_from_env(environ=None) -> DistributedConfig:
    """Read the REPRO_* variables; absent ones keep single-process
    defaults."""
    e = os.environ if environ is None else environ

    def geti(key):
        v = e.get(key)
        return int(v) if v not in (None, "") else None

    return DistributedConfig(
        coordinator_address=e.get("REPRO_COORDINATOR_ADDRESS") or None,
        num_processes=geti("REPRO_NUM_PROCESSES") or 1,
        process_id=geti("REPRO_PROCESS_ID") or 0)


def add_distributed_args(ap: argparse.ArgumentParser) -> None:
    """Attach the standard multi-process flags to a launcher parser."""
    g = ap.add_argument_group("multi-process runtime")
    g.add_argument("--coordinator", default=None,
                   help="coordinator address host:port "
                        "(env REPRO_COORDINATOR_ADDRESS)")
    g.add_argument("--num-processes", type=int, default=None,
                   help="total process count (env REPRO_NUM_PROCESSES)")
    g.add_argument("--process-id", type=int, default=None,
                   help="this process's id (env REPRO_PROCESS_ID)")


def config_from_args(args, environ=None) -> DistributedConfig:
    """CLI flags override env; unset flags fall through to env."""
    base = config_from_env(environ)

    def pick(name, fallback):
        v = getattr(args, name, None)
        return fallback if v is None else v

    return DistributedConfig(
        coordinator_address=pick("coordinator", base.coordinator_address),
        num_processes=pick("num_processes", base.num_processes),
        process_id=pick("process_id", base.process_id))


def rank_device(backend: str, device, rank: int,
                num_processes: int) -> torch.device:
    """The device rank ``rank`` of ``num_processes`` runs on (module
    docstring); raises for an unknown backend, ``nccl`` off the card, and
    ``nccl`` with more ranks than cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use gloo "
                             "on the CPU")
        return dev
    cards = torch.cuda.device_count()
    if backend == "nccl" and num_processes > cards:
        raise ValueError(
            f"nccl needs one card per rank: {num_processes} ranks, {cards} "
            f"card(s); use gloo for ranks that share a card")
    return torch.device("cuda", rank % cards)


def initialize(cfg: DistributedConfig, backend: str = "gloo",
               device=None) -> torch.device:
    """Bring this process into the group described by ``cfg`` (its
    coordinator address is required, even for one process) and return
    the device its rank runs on.  Ends with a barrier, so every rank has
    joined when it returns."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised in "
                           "this process")
    dev = rank_device(backend, device, cfg.process_id, cfg.num_processes)
    addr = cfg.coordinator_address
    if not addr:
        raise ValueError("initialize needs a coordinator address")
    init_method = addr if "://" in addr else f"tcp://{addr}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=cfg.num_processes,
                            rank=cfg.process_id)
    if backend == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
    return dev


def _rank_main(fn, rank, nproc, backend, device, init_method, args,
               results):
    """One spawned rank: join the group, run ``fn``, report to the
    parent.  The traceback of a failure is the rank's report."""
    try:
        dev = initialize(DistributedConfig(init_method, nproc, rank),
                         backend, device)
        if dev.type == "cpu":     # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
        results.put((rank, True, fn(rank, dev, *args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn, nproc: int, *, args=(), backend: str = "gloo",
                device=None, timeout: float = 600.0,
                init_method: str | None = None) -> list:
    """Run ``fn(rank, device, *args)`` in ``nproc`` new local processes,
    ranks 0..nproc-1 of one group on ``backend``, and return their
    results in rank order.

    ``fn`` must be a module-level function (it is pickled by name) and
    its result picklable.  ``device`` defaults to CUDA (:func:`rank_device`
    places each rank); the group meets at ``init_method``, by default a
    ``file://`` store in a fresh temporary directory.  A rank that
    raises, exits without a result or has not returned after ``timeout``
    seconds fails the call: the other ranks are terminated and
    ``RuntimeError`` is raised with each rank's report."""
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    rank_device(backend, device, 0, nproc)       # raises before spawning
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_dist_") as tmp:
        if init_method is None:
            init_method = f"file://{tmp}/store"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nproc, backend, device,
                                   init_method, tuple(args), results),
                             name=f"repro_torch-rank{r}")
                 for r in range(nproc)]
        for p in procs:
            p.start()
        done, failed = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) < nproc and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    failed.update({r: f"no result after {timeout} s"
                                   for r in range(nproc) if r not in done})
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    # a rank that exited cleanly has put its result, which
                    # may still be on its way; one that crashed has not
                    for r, p in enumerate(procs):
                        if r not in done and p.exitcode not in (None, 0):
                            failed[r] = (f"exited with code {p.exitcode} "
                                         f"without a result")
                    continue
                (done if ok else failed)[rank] = payload
        finally:
            for p in procs:
                if failed and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
    if failed:
        raise RuntimeError(
            f"{len(failed)} of {nproc} ranks failed:\n" + "\n".join(
                f"--- rank {r}: {msg}" for r, msg in sorted(failed.items())))
    return [done[r] for r in range(nproc)]


# ---------------------------------------------------------------------------
# smoke entry point (what scripts/launch_multiprocess_torch.sh runs per
# process)
# ---------------------------------------------------------------------------

def runtime_info() -> dict:
    """Process and device topology as this process sees it: one rank per
    process, one device per rank (after :func:`initialize`, or a lone
    process without it)."""
    up = dist.is_initialized()
    count = dist.get_world_size() if up else 1
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": count, "local_device_count": 1,
            "global_device_count": count}


def _smoke(expect_processes: int | None, global_collective: bool,
           dev: torch.device, backend: str) -> None:
    info = runtime_info()
    if expect_processes is not None \
            and info["process_count"] != expect_processes:
        raise SystemExit(f"expected {expect_processes} processes, runtime "
                         f"reports {info['process_count']}")
    # per-process compute on this rank's own device
    x = torch.arange(4, dtype=torch.float32, device=dev)
    total = float(x.sum())
    assert total == 6.0, total
    line = (f"SMOKE_OK proc={info['process_index']}/"
            f"{info['process_count']} device={dev} "
            f"local={info['local_device_count']} "
            f"global={info['global_device_count']} local_sum={total:.0f}")
    if global_collective and info["process_count"] > 1:
        # gloo reduces host memory: a card's tensor goes through the host
        y = torch.ones(1, dtype=torch.float32, device=dev)
        y = y.cpu() if backend == "gloo" else y
        dist.all_reduce(y)
        if float(y) != info["process_count"]:
            raise SystemExit(f"all_reduce gave {float(y)}, expected "
                             f"{info['process_count']}")
        line += f" global_sum={float(y):.0f}"
    # one write, so the processes' lines do not interleave on a shared
    # pipe
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (line + "\n").encode())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="multi-process bring-up smoke (per-process worker)")
    add_distributed_args(ap)
    ap.add_argument("--smoke", action="store_true",
                    help="run the bring-up smoke and exit")
    ap.add_argument("--expect-processes", type=int, default=None,
                    help="fail unless the runtime reports exactly this "
                         "many processes")
    ap.add_argument("--global-collective", action="store_true",
                    help="also run an all_reduce over every process")
    ap.add_argument("--backend", default="gloo", choices=BACKENDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    try:
        if cfg.num_processes > 1:
            dev = initialize(cfg, args.backend, args.device)
        else:
            dev = rank_device(args.backend, args.device, 0, 1)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"error: {e}") from None
    try:
        _smoke(args.expect_processes, args.global_collective, dev,
               args.backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
