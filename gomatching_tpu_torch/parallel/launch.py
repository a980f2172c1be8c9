"""One process per card, as detectron2's ``launch`` (the reference train_net.py:198-208).

``launch(main_fn, num_gpus, num_machines, machine_rank, dist_url, args)`` spawns
``num_gpus`` processes on this machine; process ``local_rank`` joins the default group
as rank ``machine_rank * num_gpus + local_rank`` of ``num_machines * num_gpus``, binds
``cuda:{local_rank}`` (or the CPU, or one named device that every rank shares) and calls
``main_fn(*args)``. What each call returns comes back in rank order. A rank that raises
or dies fails the whole launch: the others are stopped and the launch raises; it never
returns as if all had finished. The launch itself has no deadline unless the caller
gives one (``timeout_s``: the tests, ``chip_smoke.py``): a training run lasts as long as
it lasts, and a rank that hangs fails its peers' next collective after the group's
timeout (``mesh.DEFAULT_TIMEOUT_S``), which fails the launch.

``dist_url``: ``tcp://host:port``, ``host:port``, ``file://path`` (a rendezvous file, as
the tests use: TCP ports collide across concurrent test workers), or ``auto``:
``env://`` from ``MASTER_ADDR`` / ``MASTER_PORT``, or, on one machine without them, a free
port on localhost (detectron2's ``auto``). The backend is NCCL on cards and gloo on the
CPU; ``backend`` is a function argument (``chip_smoke.py`` runs two gloo ranks on one
card, which NCCL refuses), not a flag or a config key.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from .mesh import DEFAULT_TIMEOUT_S, init_distributed


def init_method_of(dist_url: str, num_machines: int = 1) -> str:
    """The ``init_method`` of ``torch.distributed`` for a ``--dist-url``."""
    if dist_url == "auto":
        if num_machines == 1 and not os.environ.get("MASTER_ADDR"):
            return f"tcp://127.0.0.1:{free_port()}"
        return "env://"
    if dist_url.startswith(("tcp://", "file://", "env://")):
        return dist_url
    if ":" in dist_url:
        return "tcp://" + dist_url
    raise ValueError(f"--dist-url {dist_url!r}: expected tcp://host:port, host:port, "
                     "file://path or auto")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve_num_gpus(num_gpus: int, cpu: bool) -> int:
    """``--num-gpus``: 0 means every visible card (JAX ``train_net.py:279``); under
    ``--cpu`` the number of processes must be given."""
    if num_gpus > 0:
        return num_gpus
    if num_gpus < 0:
        raise ValueError(f"--num-gpus {num_gpus}: expected 0 (all cards) or a count")
    if cpu:
        raise ValueError("--num-gpus 0 means every visible card; with --cpu give the number "
                         "of processes")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("--num-gpus 0: no CUDA device is visible; pass --cpu and a count "
                           "to run on the CPU")
    return n


def _worker(local_rank, main_fn, args, num_gpus, machine_rank, world, init_method, backend,
            device, threads, collective_s, result_dir):
    torch.set_num_threads(threads)
    dev = torch.device("cuda", local_rank) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = machine_rank * num_gpus + local_rank
    init_distributed(backend, init_method, world, rank, collective_s)
    try:
        out = main_fn(*args)
        torch.save(out, os.path.join(result_dir, f"rank{local_rank}.pt"))
    except BaseException:
        with open(os.path.join(result_dir, f"rank{local_rank}.err"), "w") as f:
            f.write(f"-- rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        torch.distributed.destroy_process_group()


def launch(main_fn: Callable, num_gpus: int, num_machines: int = 1, machine_rank: int = 0,
           dist_url: str = "auto", args: Sequence = (), backend: Optional[str] = None,
           device: Optional[str] = None, timeout_s: Optional[float] = None) -> List:
    """Run ``main_fn(*args)`` in ``num_gpus`` spawned processes of a process group of
    ``num_machines * num_gpus`` ranks; returns each local rank's result in rank order.

    ``device``: None binds ``cuda:{local_rank}`` (refused when there are fewer visible
    cards than ``num_gpus``); ``"cpu"`` runs every rank on the CPU; any other device
    (``"cuda:0"``) puts every rank on it, which only gloo allows. ``backend``: None takes
    NCCL on cards and gloo on the CPU. ``timeout_s``: None joins until the ranks exit; a
    number fails the launch when a rank outlives it, and caps the group's collective
    timeout. With one rank in all, ``main_fn`` runs in this process, with no process
    group. ``main_fn`` and ``args`` must pickle (a module-level function)."""
    if num_gpus < 1 or num_machines < 1 or not 0 <= machine_rank < num_machines:
        raise ValueError(f"launch of {num_gpus} processes on machine {machine_rank} of "
                         f"{num_machines}")
    world = num_machines * num_gpus
    if world == 1:
        return [main_fn(*args)]
    cpu = device == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    if backend == "nccl" and device is not None and num_gpus > 1:
        raise ValueError("NCCL cannot put two ranks on one device; use backend='gloo'")
    if not cpu:
        visible = torch.cuda.device_count()
        if device is None and num_gpus > visible:
            raise ValueError(f"--num-gpus {num_gpus} asks for more cards than the {visible} "
                             "visible ones")
        if device is not None and visible == 0:
            raise RuntimeError(f"device {device} requested but no CUDA device is visible")
    init_method = init_method_of(dist_url, num_machines)
    # the CPU ranks share this process's intra-op threads
    threads = max(1, torch.get_num_threads() // num_gpus) if cpu else torch.get_num_threads()
    collective_s = DEFAULT_TIMEOUT_S if timeout_s is None else min(timeout_s,
                                                                   DEFAULT_TIMEOUT_S)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="launch_") as result_dir:
        ctx = mp.start_processes(
            _worker, args=(main_fn, tuple(args), num_gpus, machine_rank, world, init_method,
                           backend, device, threads, collective_s, result_dir),
            nprocs=num_gpus, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"launch: a rank outlived its {timeout_s:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            # the first rank to exit may be one that lost its peer: report every rank that
            # raised, the cause among them
            errors = []
            for r in range(num_gpus):
                path = os.path.join(result_dir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f.read())
            raise RuntimeError("launch: a rank failed\n" + ("\n".join(errors) or str(e))) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(result_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(num_gpus)]
