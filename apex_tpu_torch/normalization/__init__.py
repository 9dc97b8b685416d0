"""Normalization (counterpart of ``apex_tpu.normalization``)."""
