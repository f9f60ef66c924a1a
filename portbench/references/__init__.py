"""One plain reference a file: ``<name>.py``, which a configuration names
under ``reference``, exports

* ``expected(edges, n, config, seed, root)``: the exact answer, a tensor
  ``[n]``, worked out from the generator's edge list alone;
* ``control(edges, n, config, seed, root)``: the same computation with one
  guarantee broken, which the check has to find wrong (``run.py
  --control 1`` puts it in the program's place);
* optionally ``source(edges, n, seed)``: the job's source vertex, for a
  program that starts from one.

No file here imports anything of the program."""
