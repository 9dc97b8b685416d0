"""Transformer building blocks (counterpart of ``apex_tpu.transformer``)."""
