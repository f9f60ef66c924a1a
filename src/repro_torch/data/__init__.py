"""Token data pipelines (the counterpart of ``repro.data``)."""
