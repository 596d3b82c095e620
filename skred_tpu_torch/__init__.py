"""skred_tpu_torch — the PyTorch/CUDA port of skred_tpu.

Same module layout as ``skred_tpu``: ``lang``, ``host`` and ``assets`` are
copies of its jax-free control plane, ``parallel.batch`` packs scripts
into batches, ``engine.fused`` renders them block by block through the
hand-written CUDA kernels of ``engine.kernels`` (built with nvcc at first
use).  Imports torch and numpy, never JAX or ``skred_tpu``.  Entry points
run on the card unless called with ``device="cpu"``.
"""
