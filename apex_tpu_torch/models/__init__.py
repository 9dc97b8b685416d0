"""Model zoo (counterpart of ``apex_tpu.models``): the llama, gpt2 and
bert families."""
