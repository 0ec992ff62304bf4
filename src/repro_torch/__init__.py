"""PyTorch/CUDA port of the D1HT serving plane.

Mirrors ``repro``'s layout (configs, core, runtime, kernels, models,
serve) so each module's counterpart is easy to find.  The port imports
``torch`` and never ``jax`` nor anything of ``repro``: numpy-only
modules it needs are copied here.  Its kernels (ring lookup, decode and
flash attention, EDRA tree, selective scan) are CUDA C++ for Hopper
(``csrc/``), built at first use by ``kernels/build.py``.
"""
