"""One graph generator a file: ``<name>.py`` exports ``generate(config,
seed, device)``, which returns the configuration's cleaned undirected edge
list, ``[E, 2]`` int64 on ``device``, one row ``(lo, hi)`` an edge,
``lo < hi``, sorted; the same seed gives the same list.  A configuration
names its generator under ``generator``."""
