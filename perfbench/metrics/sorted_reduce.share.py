"""sorted_reduce.share (%, layer "runtime-target reduces"): the device time
of the operations launched inside ``plan.combine_sorted`` and
``plan.combine_sorted_flat`` over all device time in the traced window;
moves evps."""

RANGES = {"repro_torch.core.plan:combine_sorted": "plan.combine_sorted",
          "repro_torch.core.plan:combine_sorted_flat": "plan.combine_sorted"}


def read(run):
    t = run.trace
    if t is None or t.device_s <= 0:
        return None
    inside = t.range_device_s.get("plan.combine_sorted", 0.0)
    if inside <= 0:
        return None
    return 100.0 * inside / t.device_s
