"""One rank of a multi-process run of the port (strainer2_tpu_torch), on
the CPU over gloo: the twin of tests/_dist_worker.py, and the launcher the
tests use to start the ranks (``launch``, ``run_ranks``).

    python tests/_torch_dist_worker.py RANK NPROC PORT WORKDIR MODE

Brings the group up on 127.0.0.1:PORT, then runs MODE with the inputs
named in WORKDIR/args.json (paths relative to the working directory it
is started in) and writes what the test compares under WORKDIR, suffixed
with its rank.  Batches are 8 x 1024: the plain torch kernels work
through every window of a batch, and the outputs do not depend on the
geometry.
"""

import io
import json
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass

ROWS, ROW_LEN = 8, 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "tests", "golden", "mini")
_LAUNCH_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def free_port() -> str:
    """A localhost port that was free a moment ago (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def base_env(extra: dict | None = None) -> dict:
    """The test process's environment with this checkout on PYTHONPATH and
    no launch variables of its own."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_VARS + ("PYTHONPATH",)}
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def run_ranks(argvs: list, envs: list, cwd: str = MINI, timeout: float = 240) -> list:
    """Start one process a rank (``argvs[i]``, ``envs[i]``), wait for all
    of them (killing any left when one times out) and return
    (returncode, stdout, stderr) a rank."""
    procs = [subprocess.Popen(a, cwd=cwd, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for a, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def launch(workdir, mode: str, args: dict, nproc: int = 2, extra_env: dict | None = None,
           expect_rc: int | None = 0, timeout: float = 240) -> list:
    """Run MODE of this worker on ``nproc`` ranks from the mini data's
    directory, with ``args`` as WORKDIR/args.json; (returncode, stdout,
    stderr) a rank."""
    with open(os.path.join(workdir, "args.json"), "w") as f:
        json.dump(args, f)
    port = free_port()
    argvs = [[sys.executable, os.path.abspath(__file__), str(i), str(nproc), port, str(workdir),
              mode] for i in range(nproc)]
    outs = run_ranks(argvs, [base_env(extra_env)] * nproc, timeout=timeout)
    if expect_rc is not None:
        for i, (rc, out, err) in enumerate(outs):
            assert rc == expect_rc, f"rank {i} exited {rc}:\n{(out + err).decode(errors='replace')[-3000:]}"
    return outs


def _small_batches():
    """Small default batch geometry in the stage configs, as the fused
    tests' fixture sets it (the fused runners make their own configs)."""
    from strainer2_tpu_torch.pipeline import detect, scrub_count

    @dataclass
    class SmallScrub(scrub_count.ScrubCountConfig):
        rows: int = ROWS
        row_len: int = ROW_LEN
        device: str = "cpu"

    @dataclass
    class SmallDetect(detect.DetectConfig):
        rows: int = ROWS
        row_len: int = ROW_LEN
        device: str = "cpu"

    scrub_count.ScrubCountConfig = SmallScrub
    detect.DetectConfig = SmallDetect


def main() -> None:
    pid, nproc, port, workdir, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], sys.argv[5])
    with open(os.path.join(workdir, "args.json")) as f:
        args = json.load(f)
    w = lambda name: os.path.join(workdir, name)  # noqa: E731

    import numpy as np

    from strainer2_tpu_torch.parallel.distributed import (
        gather_blobs,
        host_file_partition,
        initialize,
        merge_across_hosts,
    )

    _small_batches()
    assert initialize(f"127.0.0.1:{port}", nproc, pid) == (pid, nproc)
    assert initialize() == (pid, nproc)  # a second call is a no-op

    if mode in ("scrub", "scrub_ckpt"):
        from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

        out = io.StringIO()
        run_scrub_count(args["r"], args["a"], args["b"], c_list=args.get("c"), out=out,
                        cfg=ScrubCountConfig(),
                        checkpoint_dir=w("ckpt") if mode == "scrub_ckpt" else None)
        with open(w(f"table_{pid}.tsv"), "w") as f:
            f.write(out.getvalue())
        return

    if mode in ("detect", "detect_ckpt"):
        from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

        out = io.StringIO()
        try:
            run_detect(args["r"], args["scrubbed"], w(args.get("o", f"hits_{pid}.gz")),
                       batch_list=args["t"], background_list=args.get("g"), stdout=out,
                       cfg=DetectConfig(),
                       checkpoint_dir=w("dckpt") if mode == "detect_ckpt" else None)
        finally:  # a failed run's partial stdout too
            with open(w(f"detect_stdout_{pid}.txt"), "w") as f:
                f.write(out.getvalue())
        return

    if mode in ("fused", "multi", "multi_ckpt"):
        from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_multi_pipeline, run_pipeline

        out = io.StringIO()
        fcfg = FusedConfig(min_fraction=args["m"], device="cpu")
        if mode == "fused":
            run_pipeline(args["r"], args["a"], args["b"], args["t"], w(f"fused_out_{pid}"),
                         background_list=args.get("g"), fused_cfg=fcfg, err=io.StringIO(),
                         stdout=out)
        else:
            run_multi_pipeline(args["strains"], args["a"], args["b"], args["t"],
                               w(f"multi_out_{pid}"), fused_cfg=fcfg, err=io.StringIO(),
                               stdout=out,
                               checkpoint_dir=w("mckpt") if mode == "multi_ckpt" else None)
        with open(w(f"stdout_{pid}.txt"), "w") as f:
            f.write(out.getvalue())
        return

    if mode in ("merge_dead", "merge_stall"):
        # a rank > 0 dies (or stalls) BEFORE the collective: rank 0 must
        # end promptly with an error instead of hanging in the merge
        if pid != 0:
            if mode == "merge_stall":
                time.sleep(float(args.get("stall", 60)))
            return
        merged = merge_across_hosts(np.zeros(64, dtype=np.uint32))  # expected: exit 1
        np.save(w("merged_dead_0.npy"), merged)
        return

    # "merge": count this rank's share of the panel files through the
    # production counting path, then merge; plus the collectives on
    # values that gloo cannot carry as they are
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.scrub_count import count_panel_file

    engine = TorchKmerEngine(31, device="cpu")
    index = StrainIndex.from_fasta(args["r"], engine, ROWS, ROW_LEN)
    mine = host_file_partition(args["panels"], pid, nproc)
    counts = engine.init_counts(index)
    for path in mine:
        counts = count_panel_file(engine, index, counts, path, ROWS, ROW_LEN)
    local = index.key_values(engine.finalize_counts(counts))
    np.save(w(f"local_{pid}.npy"), local)
    np.save(w(f"merged_{pid}.npy"), merge_across_hosts(local))
    # uint32 wraps; uint64 and 2-D arrays keep their dtype and shape
    wrap = merge_across_hosts(np.array([2**32 - 1, 7, pid], dtype=np.uint32))
    wide = merge_across_hosts(np.full((2, 3), 2**40 + pid, dtype=np.uint64))
    blobs = gather_blobs(b"r" * (3 * pid))
    with open(w(f"collectives_{pid}.json"), "w") as f:
        json.dump({"wrap": wrap.tolist(), "wrap_dtype": str(wrap.dtype),
                   "wide": wide.tolist(), "wide_dtype": str(wide.dtype),
                   "blobs": [b.decode() for b in blobs]}, f)


if __name__ == "__main__":
    main()
