"""The benchmark of ``skred_tpu_torch``, the PyTorch and CUDA port:
``python3 benchmark/run.py --workload <cell> ...`` (see ``run.py``).

It imports nothing of JAX or of the JAX package ``skred_tpu``; from the
program it takes the system under test, its kernels' names and its
build log.
"""
