"""Achelous in PyTorch for NVIDIA Hopper: the serving path of the JAX
package `achelous_tpu`, module for module, NCHW throughout.

The JAX package is the reference.  Each module here names its counterpart
there; the two deformable-conv kernels of RCNet are hand-written CUDA
(`csrc/deform.cu`, bound in `ops/hopper_deform.py`).  This package imports
torch and numpy only.
"""
from achelous_tpu_torch.core.config import AchelousConfig, WIDTHS

__all__ = ["AchelousConfig", "WIDTHS"]
