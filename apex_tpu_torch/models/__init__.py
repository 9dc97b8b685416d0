"""Model zoo (counterpart of ``apex_tpu.models``): the llama, gpt2 and
bert families, the ResNet family (``resnet``, with the BatchNorm switch
of ``_common``) and the MLP (``mlp``)."""
