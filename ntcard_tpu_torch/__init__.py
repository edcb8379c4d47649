"""ntcard_tpu_torch: the ntcard device path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

It is a port of ``ntcard_tpu``, which stays the reference: every piece here
is held bit for bit against its JAX counterpart (tests/test_torch_*.py), and
the CLI byte-matches the reference goldens. The package stands alone: it
imports nothing of ``ntcard_tpu``, and keeps its own copies of the host
layer it needs (argument parsing, native decode and pack, estimator,
writers, host engine), each under its counterpart's module name.

The package root is lean: it imports neither torch nor jax. Modules that
need torch import it themselves, and no module ever imports jax.
"""

__version__ = "0.1.0"
