"""``step_mfu.train``: the model's operations per training step (from
the configuration's shapes, by the reference module's
``flops_per_step``) times the window's steps, over the window's time
and the card's float32 peak, in %.  The steps and the time the
profiler held (its start, the traced sub-window, its stop) are left
out of both."""

from portbench.frozen.roofline import FP32_FLOPS


def read(rec):
    if rec.device is None or rec.device.type != "cuda" or not rec.window_s:
        return None
    steps = rec.work.get("steps", 0) - rec.work.get("steps_traced", 0)
    seconds = rec.window_s - rec.work.get("held_s", 0.0)
    if steps <= 0 or seconds <= 0 or not rec.shapes:
        return None
    flops = rec.reference.flops_per_step(rec.shapes) * steps
    return flops / seconds / FP32_FLOPS * 100.0
