"""The route of the port's CPU stage tests: the torch engine's CPU programs.

``torch_route(monkeypatch)`` sets STRAINER2_NATIVE_COUNT=0, which keeps the
port's ``--device cpu`` runs off the host library's native routes
(tests/test_torch_native_routes.py runs those): the torch programs are the
CPU check of the card route's logic.  The JAX package reads the same
variable, so its gate is given back its own default here, in this process:
the JAX runs these tests hold the port to keep the CPU route they always
took (its native counter and classifiers).  The JAX jit route is not theirs
to check: on the CPU its engine is cuckoo whatever the index it is handed,
and a bucket index then counts wrong there.
"""


def _jax_gate(engine) -> bool:
    """strainer2_tpu.pipeline.scrub_count._use_native_counting without its
    STRAINER2_NATIVE_COUNT test."""
    import jax

    from strainer2_tpu import native
    from strainer2_tpu.pipeline.engine import KmerEngine

    return type(engine) is KmerEngine and native.available() and jax.default_backend() == "cpu"


def torch_route(monkeypatch) -> None:
    from strainer2_tpu.pipeline import scrub_count

    monkeypatch.setenv("STRAINER2_NATIVE_COUNT", "0")
    monkeypatch.setattr(scrub_count, "_use_native_counting", _jax_gate)
