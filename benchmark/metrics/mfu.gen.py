"""mfu.gen: operations of every request of the window (T5, each UNet query
at the batch the stage hooks saw, VAE decoder, vocoder; counted on the meta
device from the configuration's shapes) over the window's host-clock
seconds times the card's bf16 peak, in %: the whole call's share of the
peak, which bounds what any kernel's gain can add."""

from benchmark import yardstick


def read(run):
    if run.timer is None:
        return None
    unet = run.timer.calls("unet")
    teacher = run.state["driver"].TEACHER
    counted, flops = {}, 0
    for r in run.records:
        ub = unet.get(r.index, [])
        key = (r.clips, r.length, len(ub), ub[0] if ub else r.clips)
        if key not in counted:
            counted[key] = yardstick.generate_flops(run.pipeline, *key, teacher)
        flops += counted[key]
    return 100.0 * flops / (run.window_s * yardstick.PEAK_FLOPS)
