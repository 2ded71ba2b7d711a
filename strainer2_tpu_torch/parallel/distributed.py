"""Multi-process launch helpers of the port, over torch.distributed (gloo).

The torch twin of ``strainer2_tpu.parallel.distributed``, with the same
launch contract, so the port stays a drop-in: one process per card (or
host), each started with

    JAX_COORDINATOR_ADDRESS=host:port JAX_NUM_PROCESSES=N JAX_PROCESS_ID=r

- every process runs the same program after :func:`initialize`, and a bare
  ``cuda`` device means card ``r % torch.cuda.device_count()``
  (``pipeline/engine.resolve_device``);
- panel files and target samples are split across processes by size
  (:func:`partition_by_size`, :func:`host_file_partition`);
- each process counts or scores its share with the kernels on its card;
- the host-side count vectors are summed across processes
  (:func:`merge_across_hosts`) and the per-sample output payloads are
  gathered to every process (:func:`gather_blobs`), so that process 0
  writes the outputs.

The collectives move host numpy vectors, so they run on the gloo backend
over CPU tensors.  Gloo takes no unsigned type wider than a byte: every
array crosses as a uint8 view of its bytes and is summed in numpy in its
own dtype, so uint32 counts wrap as they do in one process.  Counts are
integers, so a multi-process result is bit-identical to a one-process run
over the same lists whatever the partition.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "host_file_partition",
    "partition_by_size",
    "merge_across_hosts",
    "gather_blobs",
    "COLLECTIVE_TIMEOUT_ENV",
    "process_index",
    "process_count",
    "launch_rank",
]

COLLECTIVE_TIMEOUT_ENV = "STRAINER2_COLLECTIVE_TIMEOUT"
_DEFAULT_COLLECTIVE_TIMEOUT_S = 3600.0
# gloo's own timeout where the watchdog is disabled: a week
_NO_TIMEOUT_S = 7 * 24 * 3600.0


def process_index() -> int:
    """This process's rank; 0 while no group is up."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes of the run; 1 while no group is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def launch_rank() -> int | None:
    """The rank this process runs as: the group's where one is up, else
    JAX_PROCESS_ID where the launch contract names a coordinator; None for
    a run of one process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() if dist.get_world_size() > 1 else None
    if os.environ.get("JAX_COORDINATOR_ADDRESS") and int(os.environ.get("JAX_NUM_PROCESSES", "1")) > 1:
        return int(os.environ.get("JAX_PROCESS_ID", "0"))
    return None


def _collective_timeout() -> float | None:
    """Seconds a cross-process collective may take before the run aborts
    with a clear error; None disables (STRAINER2_COLLECTIVE_TIMEOUT=0).

    The default is generous (1 h): ranks reach the merge skewed by however
    unevenly the panel partitioned, and a slow rank must never be taken for
    a dead one.  The point is to bound the failure, not to police
    stragglers."""
    v = os.environ.get(COLLECTIVE_TIMEOUT_ENV)
    if v is None:
        return _DEFAULT_COLLECTIVE_TIMEOUT_S
    t = float(v)
    return t if t > 0 else None


def _abort(message: str) -> None:
    """Print ``message`` on stderr and end the process with exit code 1 at
    once: the main thread may be wedged in a native collective, and a
    normal exit would tear down a group whose peer is gone."""
    try:
        sys.stdout.flush()
    except (OSError, ValueError):
        pass
    print(f"[strainer2] rank {process_index()}: {message}", file=sys.stderr, flush=True)
    os._exit(1)


_HINT = ("a peer rank likely died or stalled before the collective; aborting so the run "
         "can be restarted (checkpointed runs resume; tune with "
         f"{COLLECTIVE_TIMEOUT_ENV}, 0 disables)")


@contextlib.contextmanager
def _rank_failure_watchdog(what: str):
    """Exit 1 with an actionable message if the wrapped collective wedges
    or fails: the SPMD failure contract.

    A peer rank dying before a collective either leaves the survivors
    blocked in the transport, which the watchdog thread ends after the
    collective timeout, or (gloo's usual case: the peer's sockets close)
    makes the collective raise, which is caught here.  Either way the
    survivor exits 1 naming the collective, with no traceback and no
    hang; checkpointed runs restart and skip finished work."""
    timeout = _collective_timeout()
    done = threading.Event()
    if timeout is not None:
        def _watch():
            if not done.wait(timeout):
                _abort(f"{what} did not complete within {timeout:.0f}s — {_HINT}")

        threading.Thread(target=_watch, name="s2-collective-watchdog", daemon=True).start()
    try:
        yield
    except RuntimeError as e:  # torch.distributed's errors derive from it
        done.set()
        reason = str(e).strip().splitlines()[0] if str(e).strip() else type(e).__name__
        _abort(f"{what} failed ({reason}) — {_HINT}")
    finally:
        done.set()


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Bring up the gloo process group; a no-op for one-process runs and
    for a second call in one process.  Returns (process_index,
    process_count).

    The launch contract is the JAX CLIs': JAX_COORDINATOR_ADDRESS (host:port
    of rank 0, which serves the rendezvous), JAX_NUM_PROCESSES and
    JAX_PROCESS_ID, one process per card or host.  The group's timeout is
    the collective timeout (STRAINER2_COLLECTIVE_TIMEOUT)."""
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr and not dist.is_initialized():
        if num_processes is None:
            num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        if process_id is None:
            process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
        timeout = _collective_timeout() or _NO_TIMEOUT_S
        # Native collective code may print to raw fd 1, which would corrupt
        # the byte-exact stdout of the CLIs.  Route fd 1 to stderr for good
        # and rebind Python's sys.stdout to the original stream: every
        # output path of the package writes through Python file objects,
        # so the CLI bytes are unaffected while native chatter lands on
        # stderr.
        sys.stdout.flush()
        saved_fd1 = os.dup(1)
        os.dup2(2, 1)
        try:
            with _rank_failure_watchdog("process group bring-up"):
                dist.init_process_group(
                    "gloo", init_method=f"tcp://{addr}", world_size=num_processes,
                    rank=process_id, timeout=datetime.timedelta(seconds=timeout),
                )
        except BaseException:
            os.dup2(saved_fd1, 1)
            os.close(saved_fd1)
            raise
        # tear the group down before the interpreter's own teardown: a
        # rank that ends before its peers must not leave gloo's threads to
        # static destructors (std::terminate, exit code -6)
        atexit.register(_shutdown)
        if sys.stdout is sys.__stdout__:
            sys.stdout = os.fdopen(saved_fd1, "w")
        else:
            # a replaced stream (test capture, explicit sink) does not sit
            # on fd 1: keep the original fd alive, unused
            os.set_inheritable(saved_fd1, False)
    return process_index(), process_count()


def partition_by_size(sizes: list[int], process_index: int,
                      process_count: int) -> list[int]:
    """Greedy size-balanced assignment of items to ranks; returns this
    rank's item indices in ascending order.

    Deterministic across ranks (every rank computes the same full
    assignment and takes its share), so no coordination is needed.
    Items are identified by POSITION: duplicate inputs are supported and
    each occurrence lands on exactly one rank.
    """
    sizes_arr = np.asarray(sizes, dtype=np.int64)
    order = np.argsort(-sizes_arr, kind="stable")
    load = [0] * process_count
    mine_idx: list[int] = []
    for i in order:
        h = int(np.argmin(load))
        load[h] += int(sizes_arr[i]) or 1
        if h == process_index:
            mine_idx.append(int(i))
    return sorted(mine_idx)


def host_file_partition(paths: list[str], process_index: int,
                        process_count: int) -> list[str]:
    """Greedy size-balanced assignment of panel files to this host
    (partition_by_size over on-disk file sizes), preserving the original
    list order within this host's share."""
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(0)
    return [paths[i] for i in partition_by_size(sizes, process_index, process_count)]


def _all_gather_bytes(arr: np.ndarray) -> list[np.ndarray]:
    """Every process's ``arr`` (same shape and dtype on all), as uint8
    arrays of its bytes, indexed by rank."""
    local = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local)
    return [p.numpy() for p in parts]


def merge_across_hosts(local_counts: np.ndarray) -> np.ndarray:
    """Sum host-local count vectors over every process (bit-exact).

    Each process passes its own vector; every process gets the integer sum
    over the stacked process axis in the vector's dtype (uint32 wraps as
    in one process): order-independent, hence bit-identical to a
    one-process run over the concatenated file lists.  One-process runs
    return the input unchanged."""
    local_counts = np.asarray(local_counts)
    if process_count() == 1:
        return local_counts
    with _rank_failure_watchdog("count merge (all_gather)"):
        parts = _all_gather_bytes(local_counts)
    stacked = np.stack([p.view(local_counts.dtype).reshape(local_counts.shape) for p in parts])
    return stacked.sum(axis=0, dtype=local_counts.dtype)


def gather_blobs(local: bytes) -> list[bytes]:
    """All-gather one variable-length byte blob per process.

    Returns every process's blob, indexed by rank, on EVERY process: two
    fixed-shape rounds (the lengths as int64, then the blobs padded to the
    longest as uint8), since the collective needs one shape on all ranks.
    SPMD detection ships its per-sample output payloads to rank 0 this way
    (pipeline/detect.py); they pass through host memory, so each rank's
    share of an output must fit in RAM (zlib-compressed text, far smaller
    than the inputs scanned to make it)."""
    if process_count() == 1:
        return [local]
    arr = np.frombuffer(local, dtype=np.uint8)
    with _rank_failure_watchdog("payload gather (all_gather)"):
        n = torch.tensor([arr.size], dtype=torch.int64)
        sizes = [torch.empty_like(n) for _ in range(process_count())]
        dist.all_gather(sizes, n)
        lengths = [int(s.item()) for s in sizes]
        m = max(lengths)
        if m == 0:
            return [b""] * len(lengths)
        padded = np.zeros(m, dtype=np.uint8)
        padded[: arr.size] = arr
        parts = _all_gather_bytes(padded)
    return [p[:length].tobytes() for p, length in zip(parts, lengths)]
