"""The benchmark's yardstick: everything that decides a number.

Finding a cell's files by name (``cells``), one run's result line
(``harness``), the card check and its description (``card``), weights
and traffic drawn from the seed (``weights``, ``traffic``), the
operations and bytes of the work and the chip's peaks (``work``), the
reading of a profiler trace and the per-layer reductions (``trace``,
``readers``), and the plain reference that decides ``correct``
(``gfref``, ``refmodel``, ``checks``); ``tiny`` builds test-size cells
for the CPU tests.  None of it imports the program under test; the
drivers (``perfbench/drivers``) are the only files that call into it.
"""
