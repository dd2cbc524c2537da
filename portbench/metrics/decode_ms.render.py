"""``decode_ms.render``: mean ms of ``FramePipeline.decode`` per frame
(CUDA events around the call, over the traced window)."""


def read(rec):
    ev = rec.get("events", {}).get("decode_ms")
    return sum(ev) / len(ev) if ev else None
