"""PyTorch/CUDA port of the Booster GBDT reproduction.

Mirrors the module layout and public names of :mod:`repro` (the JAX
package, which stays the reference).  Each Pallas kernel of the TPU build
is a CUDA C++ kernel for Hopper here (``csrc/``), built by ``nvcc`` at first
use; each has a plain PyTorch version beside it, which runs for tensors on
the CPU.  Entry points run on the card unless the caller names another
device.
"""
