"""skred_tpu_torch — the PyTorch/CUDA port of skred_tpu.

Same module layout as ``skred_tpu``: ``lang``, ``host``, ``assets`` and
``io`` (the recorder) are copies of its jax-free control plane,
``parallel.batch`` packs scripts into batches, ``engine.fused`` renders
them block by block through the hand-written CUDA kernels of
``engine.kernels`` (built with nvcc at first use), ``engine.cyclic``
renders scripts with 1-sample feedback loops, and ``engine.render`` is
the bit-exact per-sample compat engine (``render_timeline``, with
per-voice capture), one kernel a chunk of blocks; ``spans`` records
named host intervals of the render paths.  Imports torch and
numpy, never JAX or ``skred_tpu``.  Entry points run on the card unless
called with ``device="cpu"``.
"""
