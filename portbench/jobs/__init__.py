"""Kinds of work, one module each, found by the traffic file's ``kind``
(``lookup.job``).  Each module's ``JOB`` is a class built as
``JOB(family, cfg, traffic, seed, device)`` (it makes its weights and
inputs and loads the program) that offers:

- ``setup()``, then ``unit()`` (one unit of work; its result goes to
  ``record``), ``samples(units)``, ``failed()``, ``release()`` (frees the
  program's state) and ``check()`` (the numbers compared with the
  reference, after the release), ``control()`` (the reference in a lower
  precision in the program's place);
- ``family``, ``batch``, ``device``, ``root_span`` (the program's span each unit runs
  under, read by ``spans.py``) and ``faults`` ({name: a context manager
  that plants the fault under the timed path}, ``faults.py``).
"""
