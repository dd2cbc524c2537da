"""``step_ms``: the window's seconds over the training steps completed in
it (the device synced at the window's end; host clock)."""


def read(rec):
    if "steps" not in rec:
        return None
    return 1e3 * rec["window_s"] / rec["steps"]
