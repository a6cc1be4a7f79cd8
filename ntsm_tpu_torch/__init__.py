"""ntsm_tpu_torch — the PyTorch/CUDA port of ntsm_tpu.

The same sample-swap detection as the JAX package ``ntsm_tpu`` (which stays
in the repository as the reference), for one NVIDIA Hopper GPU:

* plain tensor code is PyTorch, with an explicit ``device`` argument;
* every device kernel on the ``ntsm count`` path is CUDA C++ written by hand
  for ``sm_90a`` (``csrc/``), built with nvcc at first use and bound with
  ctypes; each has a plain PyTorch version beside it, which a wrapper runs
  only for CPU tensors.

Module names mirror ``ntsm_tpu`` so that each counterpart is easy to find.
This package imports neither jax nor ntsm_tpu, so a GPU host needs no jax.
"""

__version__ = "0.1.0"

from ntsm_tpu_torch.options import Options  # noqa: E402,F401
