"""Counterpart of ``apex_tpu.transformer.amp`` (the pipeline-parallel
``GradScaler``): not ported yet. Every name raises
``NotImplementedError``; it waits for the Megatron slice of the
multi-GPU port."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"apex_tpu_torch.transformer.amp.{name} is not ported yet: it "
        f"waits for the Megatron slice of the multi-GPU port (ROADMAP.md, "
        f"Queue 1 item 5)")
