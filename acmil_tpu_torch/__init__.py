"""acmil_tpu_torch — the PyTorch/CUDA port of acmil_tpu for NVIDIA Hopper.

Imports ``torch`` and never ``jax``. Plain tensor code is PyTorch; each
Pallas kernel of ``acmil_tpu`` becomes a kernel written by hand for
``sm_90a`` under ``csrc/``, built at first use by ``ops/_build.py``.
Importing the package has no side effects.
"""

__version__ = "0.1.0"
