"""``update_ms.train``: the step's time (``TrainStep.__call__``) less
``fwd_bwd_ms.train``, on the same sampled steps: the TV gradients and
MaskedAdam (CUDA events)."""


def read(rec):
    ev = rec.get("events", {})
    full, fb = ev.get("step_call_ms"), ev.get("fwd_bwd_ms")
    if not full or not fb:
        return None
    return sum(full) / len(full) - sum(fb) / len(fb)
