"""Build the JAX package's C++ host library once, before any test process.

``strainer2_tpu/native`` builds ``libstrainer2host.so`` with ``make`` at
first use, and its Makefile links the library in place.  Under pytest-xdist
every worker imports the test modules at once, so on a tree without the
library each worker runs ``make`` together with the others, and a worker
whose own build has finished can open the file while another worker's
linker is rewriting it ("file too short").  That worker then runs without
the library for its whole life, and the tests that need it skip or fail.

So the main (or xdist controller) process runs the same ``make`` here,
before any worker starts.  This file imports neither package and adds no
fixtures; where ``make`` fails it says why and changes nothing else.
"""

import os
import subprocess

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "strainer2_tpu", "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        subprocess.run(["make", "-C", _NATIVE], check=True, capture_output=True, text=True,
                       timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or e
        print(f"conftest: could not prebuild the host library in {_NATIVE}: {detail}")
