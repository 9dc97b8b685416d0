"""Model zoo (counterpart of ``apex_tpu.models``): the llama family."""
