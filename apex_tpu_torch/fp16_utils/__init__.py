"""Counterpart of ``apex_tpu.fp16_utils`` (``FP16_Optimizer``,
``LossScaler``, the fp16 model helpers): not ported yet. Every name
raises ``NotImplementedError``; ``apex_tpu_torch.amp`` covers the loss
scaling and fp32 master weights this package would wrap."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"apex_tpu_torch.fp16_utils.{name} is not ported yet: it waits "
        f"for the fp16_utils slice (ROADMAP.md, Queue 1 item 6.5)")
