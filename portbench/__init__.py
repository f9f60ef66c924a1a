"""The benchmark of the PyTorch and CUDA port (``repro_torch``): Graphalytics
WCC and SSSP jobs to fixpoint on a Graph500 graph, on one H100.  See
``README.md``; the entry point is ``run.py``."""
