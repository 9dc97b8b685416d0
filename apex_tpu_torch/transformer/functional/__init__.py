"""Functional transformer ops (counterpart of
``apex_tpu.transformer.functional``)."""
