"""strainer2-tpu on PyTorch and CUDA: the port of ``strainer2_tpu``.

Same module names as the JAX package (io/, index/, ops/, pipeline/, cli/),
so each module's counterpart is easy to find.  The device path runs
hand-written CUDA kernels (csrc/strainer2_kernels.cu) on an NVIDIA Hopper
card; on the CPU the same calls run their plain torch versions.  This
package imports torch and never jax; the JAX package is the reference its
tests hold it to.
"""

__version__ = "0.1.0"
