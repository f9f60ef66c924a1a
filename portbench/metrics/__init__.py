"""One reader a metric: ``<name>.py`` exports ``read(run)``, which returns
the metric's value from a ``harness.Run``, or None where the run holds
nothing to read."""
