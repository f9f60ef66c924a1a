"""Decoder-LM modules (the counterpart of ``repro.models``): the dense
stack's layers, GQA attention with its KV cache, and the transformer."""
