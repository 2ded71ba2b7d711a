"""Shared flag handling of the port's CLIs.

Each CLI carries a copy of ``build_parser()`` of its twin in
``strainer2_tpu.cli`` (pinned by tests/test_torch_cli.py) and adds
``--device``.  ``--mesh DxI`` (kmer_scrub_count, strain_detect,
strainer2_tools detect-multi) lays a (data, index) device mesh over
``--device`` (parallel/sharding.py make_mesh): a bare ``cuda`` is every
visible card and must number D x I, one explicit device (``cuda:N``,
``cpu``) holds every shard.

Under the multi-process launch contract (JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID; parallel/distributed.py) each CLI does
what its JAX twin does: ``kmer_scrub_count``, ``strain_detect`` and
``strainer2_tools pipeline`` / ``pipeline-multi`` bring the process group
up and split their work across the ranks; the others run whole in each
process.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["add_device", "check_args", "mesh_shape"]


def add_device(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``parser`` with --device added."""
    parser.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default) runs the CUDA kernels, cpu their plain torch versions",
    )
    return parser


def check_args(parser: argparse.ArgumentParser, args) -> int:
    """0 when the run can go ahead; else prints why and returns the exit code."""
    from strainer2_tpu_torch.pipeline.engine import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def mesh_shape(spec: str | None) -> tuple[int, int] | None:
    """``DxI`` as the JAX CLIs parse it (strainer2_tpu/cli/strain_detect.py:
    79-81): (D, I), or None without --mesh."""
    if not spec:
        return None
    d, i = spec.lower().split("x")
    return int(d), int(i)
