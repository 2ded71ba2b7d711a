"""The port's twins of __graft_entry__.py's entry points
(strainer2_tpu_torch/parallel/dryrun.py) on the CPU: the forward step
equal to the JAX entry()'s on the same example, and the multi-device dry
run over every (data, index) factorization of 2 and 8 devices, every
shard on the CPU."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def test_entry_matches_jax_entry():
    import __graft_entry__ as g
    from strainer2_tpu_torch.parallel.dryrun import entry

    jfn, jargs = g.entry()
    fn, args = entry("cpu")
    for ours, theirs in zip(args, jargs):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    out = fn(*args)
    assert out.shape == args[0].shape and out.dtype == torch.uint32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax.jit(jfn)(*jargs)))


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip(n):
    from strainer2_tpu_torch.parallel.dryrun import dryrun_multichip

    shapes = dryrun_multichip(n, devices="cpu")["shapes"]
    assert len(shapes) == {2: 2, 8: 4}[n]
    assert all(widths == [3, 20, 100] for widths in shapes.values())


def test_dryrun_cli_on_the_cpu(capsys):
    from strainer2_tpu_torch.parallel.dryrun import main

    assert main(["--devices", "cpu", "-n", "4"]) == 0
    out = capsys.readouterr().out
    assert "entry ok" in out and "dryrun_multichip(4) ok" in out and "1x4" in out
