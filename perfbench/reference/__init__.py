"""The benchmark's plain reference.

What decides a run's ``correct``: the Schaefer-Turek channel with cylinder
assembled again from the benchmark's own frozen copy of the port's host
mesh and assembly code (``fem/``, ``mesh/``, ``assembly.py``,
``convection.py``), applied by plain torch products and solved by plain
conjugate gradients (``linalg.py``, ``systems.py``).  Nothing here imports
the program or takes a table, a state or a bound that the program made: it
reads the program's outputs only to judge them.
"""
