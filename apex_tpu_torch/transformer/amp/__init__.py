"""Counterpart of ``apex_tpu.transformer.amp`` (the pipeline-parallel
``GradScaler``): not ported yet. Every name raises
``NotImplementedError``; it waits for the multi-GPU slice."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"apex_tpu_torch.transformer.amp.{name} is not ported yet: it "
        f"waits for the multi-GPU slice (ROADMAP.md, Queue 1 item 6)")
