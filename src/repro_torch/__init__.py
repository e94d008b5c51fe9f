"""PyTorch port of the per-example gradient system, for NVIDIA Hopper.

Laid out file for file like the JAX reference package ``repro``; each
module names its counterpart. The port imports no JAX and nothing of the
reference package. Its CUDA kernels (``csrc/``) are built at first use
(``kernels/_build.py``). Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
