"""Shared flag handling of the port's CLIs.

Each CLI carries a copy of ``build_parser()`` of its twin in
``strainer2_tpu.cli`` (pinned by tests/test_torch_cli.py), adds
``--device`` and refuses the options this port does not carry yet, instead
of ignoring them.

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

__all__ = ["add_device", "check_args"]

_UNPORTED = {
    "mesh": "--mesh (device-mesh sharding)",
}


def add_device(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``parser`` with --device added."""
    parser.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default) runs the CUDA kernels, cpu their plain torch versions",
    )
    return parser


def check_args(parser: argparse.ArgumentParser, args) -> int:
    """0 when the run can go ahead; else prints why and returns the exit code."""
    for dest, what in _UNPORTED.items():
        if getattr(args, dest, None):
            parser.error(f"{what} is not supported by the torch port yet")
    from strainer2_tpu_torch.pipeline.engine import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0
