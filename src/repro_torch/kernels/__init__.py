"""The port's kernels: ``semiring_spmv`` (wrapper of ``csrc/semiring_spmv.cu``),
its plain versions in ``ref``, and the pull step around it in ``ops``."""
