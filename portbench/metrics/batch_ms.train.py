"""``batch_ms.train``: mean ms a step spends in the sampler and the gather
(``trainer.make_batch_sampler``'s draw, ``trainer.gather_batch``; CUDA
events, over the traced window)."""


def read(rec):
    ev = rec.get("events", {}).get("batch_ms")
    return sum(ev) / len(ev) if ev else None
