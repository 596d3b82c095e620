"""The plain reference and the comparison that decides ``correct``.

``frozen/`` compiles script text to per-segment voice parameters (a
frozen copy of the port's Python compiler), ``synth.py`` renders them in
NumPy, ``compare.py`` measures the gap between what the program produced
and the reference, and ``control.py`` is the reference in bfloat16, the
comparison's control.  Nothing here imports the program, JAX or the JAX
package.
"""
