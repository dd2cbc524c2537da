"""One module a traffic ``kind``, found by that name: ``render`` (frames
back to back), ``train`` (training steps). Each has ``run(ctx) -> dict``,
the run's record that the metric readers and the judge read."""
