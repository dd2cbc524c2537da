"""``fwd_bwd_ms.train``: mean ms of ``TrainStep.loss_and_grads`` (the
forward, the loss and autograd) as a pure call on the batches of a
sample of the window's steps (CUDA events)."""


def read(rec):
    ev = rec.get("events", {}).get("fwd_bwd_ms")
    return sum(ev) / len(ev) if ev else None
