"""blaze_tpu_torch: the PyTorch/CUDA port of the blaze_tpu query engine.

A second package beside ``blaze_tpu`` (the JAX reference, which it never
imports): the same plan IR, executed with torch tensors on an NVIDIA GPU,
its device kernels written by hand in CUDA C++ for Hopper (``csrc/``) with
a plain PyTorch twin each for the CPU. The first slice runs the q01 path:
in-memory source -> filter -> partial aggregate -> murmur3 hash exchange
-> final aggregate -> top-k.

    from blaze_tpu_torch import Session
    Session().execute(plan)            # on the GPU (raises without one)
    Session(device="cpu").execute(plan)
"""

from blaze_tpu_torch.runtime.session import Session

__all__ = ["Session"]
