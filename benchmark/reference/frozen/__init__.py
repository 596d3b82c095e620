"""A frozen copy of the port's Python timeline compiler, the reference's
front end: script text to per-segment voice parameters.

Copied from ``skred_tpu_torch`` (``config.py``, ``utils_libm.py``,
``assets/bank.py`` and its ``data/*.npz``, ``lang/skode.py``,
``host/engine.py``, ``host/wire.py``, ``host/timeline.py``) with the
imports made relative and the state printers stubbed out, so that an
edit of the program's compiler cannot move the yardstick.  It imports
nothing of the program.
"""
